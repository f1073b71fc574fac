"""Approximate serving (ROADMAP queue A item 9) against the JAX package:
``opentsdb_tpu_torch/sketch/serving.py`` and ``budget.py``, the
executor's ``run_approx``, ``/q``'s ``approx=1`` / ``max_error=``, and the
``sketch-plan`` subcommand.

- Over rollup tiers both packages built from the same ingest (moment
  columns at 1h, t-digest at 1d, the default allocation), the same /q
  requests to both daemons: status, plan label (``approx-1h``...),
  ``X-Tsd-Approx`` and the reported bounds equal, values within float
  tolerance, each approximate answer within its reported bound of the
  exact one; ``max_error`` met and not met; an exact caller after an
  approximate one gets the exact answer; the 400s byte for byte.
- ``allocate`` / ``render_plan`` equal on seeded workloads.
- Budgeted tiers (``sketch_byte_budget``): the tier files byte-identical,
  each package opening the other's tier without a rebuild, and the
  ``sketch-plan`` output the JAX CLI's bytes.
"""

import asyncio
import json
import os
import shutil

import numpy as np
import pytest

from opentsdb_tpu.sketch import budget as jax_budget
from opentsdb_tpu.server.tsd import TSDServer as JaxServer
from opentsdb_tpu.tools import cli as jax_cli
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.sketch import budget as port_budget
from opentsdb_tpu_torch.tools import cli as port_cli
from test_torch_rollup import (BASE, DAY, END, METRIC, ingest, jax_tsdb,
                               port_tsdb, tier_files)

Q = f"/q?start={BASE}&end={END}&json"
M = METRIC
APPROX = [
    # (target, served approximately)
    (f"{Q}&approx=1&m=sum:1h-p95:{M}", True),
    (f"{Q}&approx=1&m=p99:1h-p50:{M}%7Bdc=*%7D", True),
    (f"{Q}&approx=1&m=max:1d-p99:{M}", True),
    (f"{Q}&approx=1&m=avg:1d-p95:{M}%7Bhost=*%7D", True),
    (f"{Q}&approx=1&m=p50:1d-p50:{M}%7Bdc=d1%7D", True),
    (f"{Q}&max_error=1000&m=sum:1h-p95:{M}", True),
    (f"{Q}&max_error=1000&m=min:1d-p99:{M}%7Bdc=*%7D", True),
    # Not met: the exact path answers.
    (f"{Q}&max_error=0.000001&m=sum:1h-p95:{M}", False),
    (f"{Q}&max_error=0.000001&m=max:1d-p99:{M}", False),
    # Not a percentile downsample, or not monotone: exact.
    (f"{Q}&approx=1&m=p95:1h-avg:{M}", False),
    (f"{Q}&approx=1&m=p99:1d-avg:{M}%7Bdc=*%7D", False),
    (f"{Q}&max_error=0.5&m=p50:1h-avg:{M}", False),
    (f"{Q}&approx=1&m=dev:1h-p95:{M}", False),
    (f"{Q}&approx=1&m=sum:rate:1h-p95:{M}", False),
    # Two sub-queries, one of each.
    (f"{Q}&approx=1&m=sum:1d-p95:{M}&m=sum:1h-avg:{M}", True),
    # The exact caller after the approximate ones.
    (f"{Q}&m=sum:1h-p95:{M}", False),
    (f"{Q}&m=max:1d-p99:{M}", False),
]
ASCII = f"/q?start={BASE}&end={END}&ascii&approx=1&m=sum:1d-p95:{M}"
ERRORS = [f"{Q}&max_error=0&m=sum:1h-p95:{M}",
          f"{Q}&max_error=abc&m=sum:1h-p95:{M}",
          f"{Q}&max_error=-1&m=sum:1h-p95:{M}"]
TARGETS = [t for t, _ in APPROX] + [ASCII] + ERRORS + ["/api/queries"]


async def _get(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nConnection: close\r\n\r\n"
                 .encode())
    await writer.drain()
    data = await asyncio.wait_for(reader.read(), 60)
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    hdrs = dict(ln.split(": ", 1) for ln in lines[1:])
    return int(lines[0].split()[1]), hdrs.get("X-Tsd-Approx"), body


def _answers(server):
    async def main():
        await server.start()
        try:
            return [await _get(server.port, t) for t in TARGETS]
        finally:
            await server.stop()
    return asyncio.run(main())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    base = tmp_path_factory.mktemp("approx")
    out = {}
    for name, open_fn, server in (("jax", jax_tsdb, JaxServer),
                                  ("port", port_tsdb, TSDServer)):
        t = open_fn(str(base / name), port=0, bind="127.0.0.1")
        try:
            for part in (0, 1):
                ingest(t, part)
                t.checkpoint()
            out[name] = dict(zip(TARGETS, _answers(server(t))))
        finally:
            t.shutdown()
    return out["jax"], out["port"]


def _dps(ent):
    return np.array(list(ent["dps"].values()))


def test_approx_q_matches_the_jax_daemon(served):
    want, got = served
    n_approx = 0
    for target, approx in APPROX:
        (gs, gh, gb), (ws, wh, wb) = got[target], want[target]
        assert gs == ws == 200, (target, gb)
        assert gh == wh, target
        g, w = json.loads(gb), json.loads(wb)
        assert len(g) == len(w) > 0, target
        for ge, we in zip(g, w):
            assert list(ge) == list(we), target
            for k in ("metric", "tags", "aggregateTags", "rollup",
                      "cached"):
                assert ge[k] == we[k], (target, k)
            assert list(ge["dps"]) == list(we["dps"]), target
            np.testing.assert_allclose(_dps(ge), _dps(we), rtol=1e-6,
                                       err_msg=target)
            if "approx" in we:
                ga, wa = ge["approx"], we["approx"]
                assert ga.keys() == wa.keys()
                assert (ga["kind"], ga["res"]) == (wa["kind"], wa["res"])
                np.testing.assert_allclose(
                    [ga["error"], ga["rel_error"]],
                    [wa["error"], wa["rel_error"]], rtol=1e-9)
        served_approx = any("approx" in e for e in g)
        assert served_approx == approx, target
        if approx:
            n_approx += 1
            assert gh.split(";")[0] in ("tdigest", "moment", "moment,tdigest",
                                        "tdigest,moment"), gh
            assert any(e["rollup"].startswith("approx-") for e in g)
        else:
            assert gh is None, target
    assert n_approx == sum(a for _, a in APPROX)
    labels = {e["rollup"] for t, a in APPROX if a
              for e in json.loads(got[t][2])}
    assert {"approx-1h", "approx-1d"} <= labels
    kinds = {e["approx"]["kind"] for t, a in APPROX if a
             for e in json.loads(got[t][2]) if "approx" in e}
    assert kinds == {"moment", "tdigest"}


def test_approx_answers_lie_within_their_bound_of_the_exact_ones(served):
    """Each approximately served bucket is within its reported absolute
    bound of the exact answer to the same query (the exact caller's)."""
    _, got = served
    pairs = [(f"{Q}&approx=1&m=sum:1h-p95:{M}", f"{Q}&m=sum:1h-p95:{M}"),
             (f"{Q}&approx=1&m=max:1d-p99:{M}", f"{Q}&m=max:1d-p99:{M}")]
    for approx_t, exact_t in pairs:
        a = json.loads(got[approx_t][2])[0]
        e = json.loads(got[exact_t][2])[0]
        assert "approx" not in e and e["rollup"] == "raw"
        assert list(a["dps"]) == list(e["dps"])
        err = a["approx"]["error"]
        assert (np.abs(_dps(a) - _dps(e)) <= err * (1 + 1e-9)).all()


def test_approx_ascii_errors_and_plan_counts(served):
    want, got = served
    (gs, gh, gb), (ws, wh, wb) = got[ASCII], want[ASCII]
    assert (gs, gh) == (ws, wh) and gs == 200 and gh
    g = [ln.split() for ln in gb.decode().splitlines()]
    w = [ln.split() for ln in wb.decode().splitlines()]
    assert [r[:2] + r[3:] for r in g] == [r[:2] + r[3:] for r in w]
    np.testing.assert_allclose([float(r[2]) for r in g],
                               [float(r[2]) for r in w], rtol=1e-6)
    for t in ERRORS:
        assert got[t] == want[t], t
        assert got[t][0] == 400
    g = json.loads(got["/api/queries"][2])
    w = json.loads(want["/api/queries"][2])
    assert g["plans"] == w["plans"]
    assert g["plans"]["approx"] == sum(a for _, a in APPROX) + 1
    assert g["rollup"] == w["rollup"]
    assert sorted(g["sketch"]) == sorted(w["sketch"])


@pytest.mark.parametrize("seed", range(6))
def test_allocate_and_render_plan_equal(seed):
    rng = np.random.default_rng(seed)
    res = sorted(set(int(r) * 3600 for r in rng.choice(
        [1, 2, 6, 24, 168], int(rng.integers(1, 5)), replace=False)))
    records = {r: int(rng.integers(1, 10 ** int(rng.integers(2, 7))))
               for r in res}
    workload = (None if seed % 3 == 0 else
                {r: float(rng.integers(0, 20)) for r in res})
    for budget in (0, 10_000, int(rng.integers(1, 10 ** 8))):
        kw = dict(hll_p=int(rng.choice([4, 8, 12])))
        want = jax_budget.allocate(budget, records, workload, **kw)
        got = port_budget.allocate(budget, records, workload, **kw)
        assert {r: tuple(a) for r, a in got.items()} == \
            {r: tuple(a) for r, a in want.items()}
        assert port_budget.render_plan(got, budget) == \
            jax_budget.render_plan(want, budget)
    ring = [{"m": f"sum:{iv}-avg:x"} for iv in ("1h", "2h", "1d", "5m")] + \
        [{"query": "p95:6h-p95:y"}, {"m": "sum:x"}, {"m": 5}, {}]
    assert port_budget.workload_from_ring(ring, res) == \
        jax_budget.workload_from_ring(ring, res)
    for n in (0, 1, 256, 257, 10 ** 6):
        assert port_budget.quantize_records(n) == \
            jax_budget.quantize_records(n)
    assert port_budget.record_bytes(64, 8, 8) == \
        jax_budget.record_bytes(64, 8, 8)


BUDGET = 300_000


@pytest.mark.parametrize("shards", [1, 4])
def test_budgeted_tiers_identical_and_cross_both_ways(tmp_path, shards):
    paths = {n: str(tmp_path / n) for n in ("j", "p")}
    tiers = {}
    for name, open_fn in (("j", jax_tsdb), ("p", port_tsdb)):
        t = open_fn(paths[name], shards, sketch_byte_budget=BUDGET)
        try:
            tiers[name] = t.rollups.sketch_alloc
            for part in (0, 1):
                ingest(t, part)
                t.checkpoint()
        finally:
            t.shutdown()
    assert tiers["p"] == tiers["j"]
    assert len(set(tiers["p"].values())) > 1   # not one rung everywhere
    j, p = tier_files(paths["j"]), tier_files(paths["p"])
    assert sorted(p) == sorted(j)
    assert [k for k in j if j[k] != p[k]] == []
    state = json.loads(next(v for k, v in p.items()
                            if k.endswith(("ROLLUP.json", ".rollup.json"))))
    assert state["budget"] == BUDGET
    # Each package opens the other's budgeted tier without a rebuild.
    for name, open_fn in (("j", port_tsdb), ("p", jax_tsdb)):
        t = open_fn(paths[name], shards, sketch_byte_budget=BUDGET)
        try:
            assert t.rollups.rebuilds == 0 and t.rollups.ready
            assert t.rollups.sketch_alloc == tiers[name]
        finally:
            t.shutdown()


@pytest.mark.parametrize("args", [
    ["--budget", str(BUDGET)],
    ["--budget", "50000"],
    ["--sketch-byte-budget", str(BUDGET)],
    ["--budget", "3000000", "--sketch-byte-budget", str(BUDGET)],
    ["--budget", "0"],
    [],
])
def test_sketch_plan_cli_prints_the_jax_bytes(tmp_path, capsys, args):
    src = str(tmp_path / "s")
    t = port_tsdb(src, sketch_byte_budget=BUDGET)
    for part in (0, 1):
        ingest(t, part)
        t.checkpoint()
    t.shutdown()
    outs = []
    for name, main, extra in (("port", port_cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, ["--backend", "cpu"])):
        path = str(tmp_path / name)
        shutil.copytree(src, path)
        capsys.readouterr()
        rc = main(["sketch-plan", "--wal", os.path.join(path, "wal"),
                   *extra, *args])
        out = capsys.readouterr()
        outs.append((rc, out.out, out.err))
    assert outs[0] == outs[1]
    rc, out, err = outs[0]
    if args in ([], ["--budget", "0"]):
        assert rc == 2 and "needs --budget" in err
    else:
        assert rc == 0 and out.startswith("sketch byte budget: ")
        assert "planned total:" in out
