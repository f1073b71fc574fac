"""Two-process proof of the mesh plane across a process boundary.

The port's counterpart of ``scripts/multihost_run.py``. It forks itself
into two OS processes on 127.0.0.1, joins them into one mesh plane
(``parallel/fleet.init_plane``: a ``torch.distributed`` group over gloo,
the transport that takes two ranks on one card), and runs one of three
modes:

- default: the three hybrid kernels of ``parallel/multihost.py`` on a
  2 x C mesh whose host axis spans the two processes (each process one
  host row of C logical shards of its device), so the host-level merges
  (the moment rows, the HLL registers, the compressed digests) travel
  the real cross-process transport. Checked: the answers equal a
  one-process run over the same 2 x C shards bit for bit; they agree
  with the single-device kernels over the same points (the grouped
  downsample within rtol 1e-5 of the largest value) and with exact
  answers (HLL and t-digest within 5%); host 1's shards hold about a
  quarter of host 0's real points (uneven); process 1 sleeps 2 s before
  the first collective, and process 0's wall time shows it waited
  (straggler); and host-axis collectives on data that differs across a
  row's chips combine each chip column across the processes. Values lie
  on a 1/8 grid, so every shard's segment sums are exact whatever order
  a card's atomics add in, and a difference could only come from the
  merge. The size follows the device: on the CPU a small one (4 chips a
  process, one series of 4,096 points a shard, B = 24); on a card the
  week of ``chip_smoke.py``'s fleet phase (10,000 series of 1,000 points
  in 2 x 2 shards, hourly buckets, B = 256).
- ``--plane``: a flat series mesh of 2 x C shards across the processes.
  The sharded rollup window fold (each process checks its own shards)
  and a sharded dashboard reduction (a whole-mesh combine, gathered
  across the processes) are byte-identical to one-device controls on
  integer-valued data.
- ``--serve``: each process is one ``tsd --mesh-plane`` member: it
  joins the plane, builds a TSDB whose resident hot set is sharded over
  2 logical shards (``--devwindow-shards 2``), serves HTTP on an
  ephemeral port and checks its own ``/healthz`` width and ``plane``,
  its resident ``/q`` against the scan path, and a live reshard to 1 and
  back with identical answers.

Run: ``python -m opentsdb_tpu_torch.tools.multihost_run [--plane |
--serve] [--device cpu|cuda] [--out DIR]``. Each child prints one JSON
line; the parent prints the merged record as its last line and, with
``--out``, writes it to ``DIR/multihost_<mode>.json``. It writes nothing
else. Exit 0 when both children pass.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import NamedTuple

# The directory holding the package: the children import it from there.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_PROC = 2
CHIPS_PER_PROC = 4
SPAN = 7200
INTERVAL = 300
B = SPAN // INTERVAL
N_PER_SHARD = 4096
STRAGGLER_S = 2.0
# Seconds a child may take (the plane's join and collective timeout is
# below it, so a lost peer fails the child before the parent kills it).
CHILD_WALL_S = 240.0
PLANE_TIMEOUT_S = 60.0


class Size(NamedTuple):
    """The default mode's shapes: ``chips`` logical shards a process,
    ``series`` series of ``points`` points a shard over ``span`` seconds,
    ``buckets`` buckets of ``interval`` seconds."""
    chips: int
    series: int
    points: int
    span: int
    interval: int
    buckets: int


SMALL = Size(CHIPS_PER_PROC, 1, N_PER_SHARD, SPAN, INTERVAL, B)
WEEK = Size(2, 2_500, 1_000, 7 * 86400, 3600, 256)


def size_for(device: str) -> Size:
    """The card runs the week; anything else the small size."""
    return WEEK if device.startswith("cuda") else SMALL


def synth(host: int, chip: int, size: Size = SMALL):
    """Deterministic per-shard data any process can rebuild. Host 1 is
    uneven: a quarter of each series' points are real. Values on a 1/8
    grid."""
    import numpy as np

    rng = np.random.default_rng(1000 + host * 8 + chip)
    n = size.series * size.points
    n_real = size.points if host == 0 else size.points // 4
    ts = rng.integers(0, size.span, n).astype(np.int32)
    vals = np.round(rng.normal(50.0 + host * 10 + chip, 5.0, n) * 8) / 8
    sid = np.repeat(np.arange(size.series, dtype=np.int32), size.points)
    valid = np.tile(np.arange(size.points) < n_real, size.series)
    return ts, vals.astype(np.float32), sid, valid


def synth_plane(shard: int):
    """Dense integer-valued per-shard data: unique timestamps covering
    every bucket (the fill never interpolates) and values whose float32
    partial sums stay exact in any order (< 2^24)."""
    import numpy as np

    rng = np.random.default_rng(7000 + shard)
    ts = rng.permutation(SPAN)[:N_PER_SHARD].astype(np.int32)
    vals = rng.integers(-500, 500, N_PER_SHARD).astype(np.float32)
    sid = np.zeros(N_PER_SHARD, np.int32)
    valid = np.ones(N_PER_SHARD, bool)
    assert len(np.unique(ts // INTERVAL)) == B
    return ts, vals, sid, valid


def _stack(shards, col):
    import numpy as np
    return np.stack([s[col] for s in shards])


def _host_columns(x, *, axis_index):
    """Host-axis collectives on data that differs across a row's chips:
    chip c of every row gets column c's sum and stack."""
    from opentsdb_tpu_torch.parallel.compile import all_gather, psum
    from opentsdb_tpu_torch.parallel.mesh import HOST_AXIS

    total = yield psum(x, axis=HOST_AXIS)
    stack = yield all_gather(x, axis=HOST_AXIS)
    return total[None], stack[None]


def child_hybrid(pid: int, coordinator: str, device: str) -> dict:
    import numpy as np
    import torch

    from opentsdb_tpu_torch.ops.kernels import downsample_group
    from opentsdb_tpu_torch.parallel import fleet
    from opentsdb_tpu_torch.parallel.compile import compile_with_plan
    from opentsdb_tpu_torch.parallel.mesh import HOST_AXIS, SERIES_AXIS, Mesh
    from opentsdb_tpu_torch.parallel.multihost import (
        hybrid_downsample_group, hybrid_hll_distinct, hybrid_tdigest,
        init_multihost, make_hybrid_mesh)
    from opentsdb_tpu_torch.parallel.plan import ExecPlan

    size = size_for(device)
    C = size.chips
    plane = fleet.init_plane(coordinator, N_PROC, pid, devices_local=C,
                             device=device, timeout_s=PLANE_TIMEOUT_S)
    assert init_multihost() is True
    mesh = make_hybrid_mesh(devices=[device] * C)
    assert mesh.global_shape == (N_PROC, C), mesh
    allsh = [synth(h, c, size) for h in range(N_PROC) for c in range(C)]
    ts, vals, sid, valid = (_stack(allsh[pid * C:(pid + 1) * C], i)
                            for i in range(4))
    kw = dict(series_per_shard=size.series, num_buckets=size.buckets,
              interval=size.interval, agg_down="avg", agg_group="sum")
    qs = [0.1, 0.5, 0.95]
    if pid == 1:
        time.sleep(STRAGGLER_S)
    t0 = time.perf_counter()
    gv, gm = hybrid_downsample_group(ts, vals, sid, valid, mesh=mesh, **kw)
    gv = gv.cpu().numpy()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = float(hybrid_hll_distinct(ts, valid, mesh=mesh, p=14))
    hll_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    tq = hybrid_tdigest(vals, valid, qs, mesh=mesh).cpu().numpy()
    td_wall = time.perf_counter() - t0
    gm = gm.cpu().numpy()
    # Host-axis collectives on per-chip data, column by column.
    xs = np.random.default_rng(5).integers(-50, 50, (N_PROC * C, 5)) \
        .astype(np.float32)
    cols = compile_with_plan(
        _host_columns, ExecPlan(
            name="multihost_run.host_columns", axis="host",
            style="shard_map", in_specs=((HOST_AXIS, SERIES_AXIS),),
            out_specs=((HOST_AXIS, SERIES_AXIS),) * 2), mesh)(
        xs[pid * C:(pid + 1) * C])
    grid = xs.reshape(N_PROC, C, 5)
    assert (cols[0].cpu().numpy() == grid.sum(axis=0)).all(), \
        "a host-axis psum did not combine each chip column"
    assert (cols[1].cpu().numpy() == grid.transpose(1, 0, 2)).all(), \
        "a host-axis all_gather did not stack each chip column"

    # The one-process run: both host rows folded on this process's
    # device list.
    a_ts, a_vals, a_sid, a_valid = (_stack(allsh, i) for i in range(4))
    one = Mesh([device] * (N_PROC * C), (HOST_AXIS, SERIES_AXIS),
               shape=(N_PROC, C))
    o_gv, o_gm = hybrid_downsample_group(a_ts, a_vals, a_sid, a_valid,
                                         mesh=one, **kw)
    o_est = float(hybrid_hll_distinct(a_ts, a_valid, mesh=one, p=14))
    o_tq = hybrid_tdigest(a_vals, a_valid, qs, mesh=one).cpu().numpy()
    assert gv.tobytes() == o_gv.cpu().numpy().tobytes(), \
        "cross-process group differs from the one-process run"
    assert (gm == o_gm.cpu().numpy()).all()
    assert np.float32(est).tobytes() == np.float32(o_est).tobytes()
    assert tq.tobytes() == o_tq.tobytes(), \
        "cross-process t-digest differs from the one-process run"
    del o_gv, o_gm, one

    # The single-device kernels over the same points, series numbered
    # across the shards.
    n_series = N_PROC * C * size.series
    g_sid = (a_sid + size.series * np.arange(N_PROC * C,
                                            dtype=np.int32)[:, None])
    ref = downsample_group(
        *(torch.from_numpy(x.ravel()).to(device)
          for x in (a_ts, a_vals, g_sid, a_valid)),
        num_series=n_series, num_buckets=size.buckets,
        interval=size.interval, agg_down="avg", agg_group="sum")
    wmask = ref["group_mask"].cpu().numpy()
    want = ref["group_values"].cpu().numpy().astype(np.float64)
    assert (gm == wmask).all(), "bucket masks disagree"
    scale = float(np.abs(want[wmask]).max())
    ds_err = float(np.abs(gv[wmask] - want[wmask]).max())
    assert ds_err <= 1e-5 * scale, ds_err
    del ref, g_sid
    exact = len(np.unique(a_ts[a_valid]))
    hll_rel = abs(est - exact) / exact
    assert hll_rel < 0.05, hll_rel
    f_vals = a_vals[a_valid]
    want_q = np.quantile(f_vals, qs)
    td_rel = float(np.abs((tq - want_q) / want_q).max())
    assert td_rel < 0.05, td_rel
    if pid == 0:
        assert wall >= 0.75 * STRAGGLER_S, \
            f"straggler not awaited: the collective returned in {wall:.2f}s"
    torch.cuda.synchronize() if device.startswith("cuda") else None
    n_real = int(a_valid.sum())
    return {"plane": plane, "mesh": list(mesh.global_shape),
            "size": size._asdict(), "points_real": n_real,
            "uneven_shards": {"host0_real": size.series * size.points,
                              "host1_real": int(allsh[C][3].sum())},
            "group_values": gv.tolist(), "group_mask": gm.tolist(),
            "hll_estimate": est, "tdigest": tq.tolist(), "qs": qs,
            "bit_identical_to_one_process": True,
            "host_columns_exact": True,
            "downsample_group_max_abs_err": ds_err,
            "downsample_group_scale": scale,
            "hll_rel_err": hll_rel, "tdigest_rel_err": td_rel,
            "straggler_delay_s": STRAGGLER_S,
            "group_wall_s": wall, "hll_wall_s": hll_wall,
            "tdigest_wall_s": td_wall}


def child_plane(pid: int, coordinator: str, device: str) -> dict:
    import numpy as np
    import torch

    from opentsdb_tpu_torch.parallel import fleet
    from opentsdb_tpu_torch.parallel.mesh import Mesh, make_mesh
    from opentsdb_tpu_torch.parallel.sharded import (
        _sharded_window_fold_body, sharded_downsample_group,
        sharded_window_fold)

    plane = fleet.init_plane(coordinator, N_PROC, pid,
                             devices_local=CHIPS_PER_PROC, device=device,
                             timeout_s=PLANE_TIMEOUT_S)
    mesh = make_mesh(CHIPS_PER_PROC, devices=[device] * CHIPS_PER_PROC,
                     plane=fleet.plane())
    rows = N_PROC * CHIPS_PER_PROC
    assert mesh.size == rows
    base = pid * CHIPS_PER_PROC
    mine = [synth_plane(base + c) for c in range(CHIPS_PER_PROC)]
    ts, vals, sid, valid = (_stack(mine, i) for i in range(4))
    res = 600
    num_windows = SPAN // res
    folded = sharded_window_fold(ts, vals, sid, valid, mesh=mesh,
                                 series_per_shard=1,
                                 num_windows=num_windows, res=res)
    checked = 0
    for c in range(CHIPS_PER_PROC):
        t0, v0, s0, m0 = (torch.from_numpy(x).to(device)
                          for x in synth_plane(base + c))
        want = _sharded_window_fold_body(t0, v0, s0, m0, axis_index=0,
                                         series_per_shard=1,
                                         num_windows=num_windows, res=res)
        assert folded[c].cpu().numpy().tobytes() == \
            want[0].cpu().numpy().tobytes(), f"fold shard {base + c}"
        checked += 1
    gv, gm = sharded_downsample_group(
        ts, vals, sid, valid, mesh=mesh, series_per_shard=1,
        num_buckets=B, interval=INTERVAL, agg_down="sum", agg_group="sum")
    allsh = [synth_plane(d) for d in range(rows)]
    c_ts = np.concatenate([s[0] for s in allsh])[None]
    c_vals = np.concatenate([s[1] for s in allsh])[None]
    c_sid = np.concatenate(
        [np.full(N_PER_SHARD, d, np.int32) for d in range(rows)])[None]
    c_valid = np.concatenate([s[3] for s in allsh])[None]
    c_gv, c_gm = sharded_downsample_group(
        c_ts, c_vals, c_sid, c_valid, mesh=Mesh([device]),
        series_per_shard=rows, num_buckets=B, interval=INTERVAL,
        agg_down="sum", agg_group="sum")
    assert torch.equal(gm.cpu(), c_gm.cpu()), "reduction masks disagree"
    assert gv.cpu().numpy().tobytes() == c_gv.cpu().numpy().tobytes(), \
        "mesh reduction differs from the one-device control"
    return {"plane": plane, "fold_shards_byte_checked": checked,
            "fold_windows": num_windows, "reduction_buckets": B,
            "reduction_byte_identical": True,
            "reduction": gv.cpu().numpy().tolist()}


def child_serve(pid: int, coordinator: str, device: str) -> dict:
    import asyncio
    import shutil
    import tempfile

    import numpy as np

    from opentsdb_tpu_torch.core.tsdb import TSDB
    from opentsdb_tpu_torch.parallel import fleet
    from opentsdb_tpu_torch.server.tsd import TSDServer
    from opentsdb_tpu_torch.storage.kv import MemKVStore
    from opentsdb_tpu_torch.utils.config import Config

    shards = 2
    plane = fleet.init_plane(coordinator, N_PROC, pid,
                             devices_local=shards, device=device,
                             timeout_s=PLANE_TIMEOUT_S)
    assert plane["devices_global"] == N_PROC * shards, plane
    work = tempfile.mkdtemp(prefix=f"meshserve{pid}-")
    wal = os.path.join(work, "wal")
    cfg = Config(device=device, auto_create_metrics=True,
                 device_window=True, devwindow_shards=shards,
                 mesh_plane=coordinator, mesh_plane_procs=N_PROC,
                 mesh_plane_id=pid, enable_sketches=False,
                 enable_rollups=False, port=0, bind="127.0.0.1")
    tsdb = TSDB(MemKVStore(wal_path=wal), cfg,
                start_compaction_thread=False)
    dw = tsdb.devwindow
    assert hasattr(dw, "shard_of") and dw.n_shards == shards
    base = 1356998400
    metric = "mesh.serve.cpu"
    rng = np.random.default_rng(31 + pid)
    for i in range(8):
        ts = base + np.arange(0, SPAN, 60, dtype=np.int64)
        vals = rng.integers(0, 500, len(ts)).astype(np.float64)
        tsdb.add_batch(metric, ts, vals, {"host": f"p{pid}h{i}"})
    server = TSDServer(tsdb)
    qtarget = (f"/q?start={base}&end={base + SPAN}"
               f"&m=sum:10m-avg:{metric}&json")

    async def get(port, target):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"GET {target} HTTP/1.1\r\nHost: x\r\n"
                     "Connection: close\r\n\r\n".encode())
        await writer.drain()
        data = await asyncio.wait_for(reader.read(), 60)
        writer.close()
        head, _, body = data.partition(b"\r\n\r\n")
        return int(head.split(b" ", 2)[1]), body

    async def drive(port):
        st, body = await get(port, "/healthz")
        assert st == 200, body
        mesh = json.loads(body)["mesh"]
        assert mesh["width"] == shards, mesh
        assert mesh["plane"]["process_count"] == N_PROC, mesh
        assert mesh["plane"]["process_id"] == pid, mesh
        assert mesh["plane"]["devices_global"] == N_PROC * shards, mesh
        hits0 = dw.window_hits
        st, body = await get(port, qtarget)
        assert st == 200, body
        served = json.loads(body)
        assert dw.window_hits > hits0, "the query missed the resident set"
        assert served[0]["rollup"] == "resident", served[0]["rollup"]
        tsdb.devwindow = None
        try:
            st, scan_body = await get(port, qtarget)
        finally:
            tsdb.devwindow = dw
        scanned = json.loads(scan_body)
        assert scanned[0]["rollup"] == "raw"
        assert served[0]["dps"].keys() == scanned[0]["dps"].keys()
        for k, v in served[0]["dps"].items():
            w = scanned[0]["dps"][k]
            assert abs(v - w) <= 1e-5 * max(1.0, abs(w)), k
        widths = []
        for n in (1, shards):
            st, rbody = await get(port, f"/api/mesh/reshard?shards={n}")
            assert st == 200, rbody
            assert json.loads(rbody)["n_shards"] == n
            st, again = await get(port, qtarget)
            assert st == 200
            assert json.loads(again)[0]["dps"] == served[0]["dps"], n
            widths.append(json.loads((await get(port, "/healthz"))[1])
                          ["mesh"]["width"])
        st, body = await get(port, "/healthz")
        res = json.loads(body)["mesh"]["resident"]
        assert res["reshards"] == 2 and res["shards"] == shards, res
        return {"widths_after_reshards": widths,
                "last_reshard_ms": res["last_reshard_ms"]}

    async def amain():
        await server.start()
        try:
            return await drive(server.port)
        finally:
            await server.stop()

    r = asyncio.run(amain())
    tsdb.shutdown()
    shutil.rmtree(work, ignore_errors=True)
    return {"plane": plane, "width_advertised": shards,
            "resident_query_parity": True,
            "live_reshard": [1, shards], "reshard_answers_identical": True,
            **r}


CHILDREN = {"hybrid": child_hybrid, "plane": child_plane,
            "serve": child_serve}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_parent(mode: str, device: str, out_dir: str | None,
               wall_s: float = CHILD_WALL_S) -> dict:
    """Fork both children, wait for them (each within ``wall_s``), and
    return the merged record."""
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for pid in range(N_PROC):
        env = dict(os.environ, MH_PROCESS_ID=str(pid),
                   MH_COORDINATOR=coord, MH_MODE=mode, MH_DEVICE=device)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "opentsdb_tpu_torch.tools.multihost_run"],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    t0 = time.monotonic()
    recs, errors = [], []
    for pid, p in enumerate(procs):
        left = max(1.0, wall_s - (time.monotonic() - t0))
        try:
            out, err = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            errors.append(f"process {pid}: past its {wall_s:.0f} s wall")
            continue
        if p.returncode != 0:
            errors.append(f"process {pid} rc={p.returncode}:\n"
                          f"{err[-3000:]}")
            continue
        recs.append(json.loads(out.strip().splitlines()[-1]))
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    rec = {"mode": mode, "device": device, "ok": not errors,
           "processes": recs, "errors": errors,
           "wall_s": round(time.monotonic() - t0, 3)}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"multihost_{mode}.json"),
                  "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    role = os.environ.get("MH_PROCESS_ID")
    if role is not None:
        rec = CHILDREN[os.environ["MH_MODE"]](
            int(role), os.environ["MH_COORDINATOR"],
            os.environ["MH_DEVICE"])
        from opentsdb_tpu_torch.parallel import fleet
        fleet._reset_for_tests()
        print(json.dumps(rec))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--plane", action="store_true")
    g.add_argument("--serve", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of each process's shards "
                         "(cuda: logical shards of this machine's card)")
    ap.add_argument("--out", default=None,
                    help="directory for multihost_<mode>.json")
    ap.add_argument("--wall", type=float, default=CHILD_WALL_S,
                    help="seconds the children may take")
    args = ap.parse_args(argv)
    mode = "plane" if args.plane else "serve" if args.serve else "hybrid"
    rec = run_parent(mode, args.device, args.out, args.wall)
    for e in rec["errors"]:
        print(e, file=sys.stderr)
    print(json.dumps({k: v for k, v in rec.items() if k != "processes"}
                     | {"processes": len(rec["processes"])}))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
