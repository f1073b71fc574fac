"""The port's storage tools (``tsdb import / query / scan / uid /
mkmetric``, opentsdb_tpu_torch/tools/cli.py) and ops tools (``check``,
``drain``, ``clean-cache``, opentsdb_tpu_torch/tools/ops.py) against the
JAX package's: the scenarios of tests/test_tools.py and
tests/test_ops_tools.py through both CLIs (the port with ``--device
cpu``), the stores crossing both ways.

Contracts:
- every command prints the JAX CLI's bytes and exits with its code; an
  import's timing figures are the one difference allowed, and a query's
  values agree within the executors' float32 tolerance (rtol 1e-5) where
  their last digit differs;
- a store written by either CLI reads the same through both;
- ``query --graph`` exits 2 with "not yet ported" (PNG);
- the ops tools' functions give the JAX module's results on the same
  inputs; ``check`` against either daemon answers alike; ``drain`` writes
  the same files; ``clean-cache`` removes the same files.
"""

import argparse
import asyncio
import copy
import gzip
import json
import os
import re
import threading
import time

import numpy as np
import pytest

from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.server.tsd import TSDServer as JaxServer
from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
from opentsdb_tpu.tools import cli as jax_cli
from opentsdb_tpu.tools import ops as jax_ops
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.tools import cli as port_cli
from opentsdb_tpu_torch.tools import ops as port_ops
from opentsdb_tpu_torch.utils.config import Config

BT = 1356998400
_STORE_TOOLS = ("import", "query", "scan", "uid", "mkmetric")
_TIMING = re.compile(r"in \d+\.\d+s \([\d,]+ points/s\)")


def run(pkg, argv, capsys):
    """One ``tsdb`` command of ``pkg``: (exit code, stdout)."""
    argv = list(argv)
    if pkg == "port" and argv[0] in _STORE_TOOLS:
        argv[1:1] = ["--device", "cpu"]
    capsys.readouterr()
    rc = (jax_cli.main if pkg == "jax" else port_cli.main)(argv)
    return rc, _TIMING.sub("in T", capsys.readouterr().out)


def same_lines(got: str, want: str):
    """Line for line equal, but for a value's last digits within the
    float32 tolerance (``metric ts value tags`` lines)."""
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if a == b:
            continue
        pa, pb = a.split(" "), b.split(" ")
        assert pa[:2] == pb[:2] and pa[3:] == pb[3:], (a, b)
        np.testing.assert_allclose(float(pa[2]), float(pb[2]), rtol=1e-5)


def _datafile(tmp_path):
    rng = np.random.default_rng(7)
    lines = [f"sys.cpu.user {BT + i * 10} {i} host=web01" for i in range(6)]
    lines += [f"m.ds {BT + i * 10} {i} a=b" for i in range(12)]
    lines += [f"m.f {BT + i * 37} {v!r} host=h{i % 3} dc=d{i % 2}"
              for i, v in enumerate(rng.normal(50, 5, 120).round(3)
                                    .tolist())]
    lines += [f"m.big {BT + i} {2**40 + i} x=y" for i in range(5)]
    lines += [f"m.scan {BT + 1} 42 a=b", f"m.scan {BT + 2} 4.25 a=b"]
    path = tmp_path / "data.txt"
    path.write_text("\n".join(lines) + "\n")
    gz = tmp_path / "data.txt.gz"
    with gzip.open(gz, "wt") as f:
        f.write(f"m.gz {BT} 1.25 a=b\n")
    return [str(path), str(gz)]


READS = [
    ["query", str(BT), str(BT + 60), "sum", "sys.cpu.user", "host=web01"],
    ["query", str(BT), str(BT + 120), "sum", "downsample", "60", "avg",
     "m.ds"],
    ["query", str(BT), str(BT + 5000), "sum", "m.f", "host=*"],
    ["query", str(BT), str(BT + 5000), "max", "rate", "m.f", "dc=d1"],
    ["query", str(BT), str(BT + 5000), "avg", "downsample", "600", "dev",
     "m.f"],
    ["query", str(BT), str(BT + 10), "sum", "m.big"],
    ["query", str(BT), str(BT + 5), "sum", "m.gz"],
    ["scan", "--import", str(BT), str(BT + 10), "m.scan"],
    ["scan", str(BT), str(BT + 10), "m.scan"],
    ["scan", "--import", str(BT), str(BT + 5000), "m.f", "dc=d0"],
    ["uid", "grep", "metrics", "^m"],
    ["uid", "grep", "e"],
    ["uid", "metrics", "m.f"],
    ["uid", "tagk", "nope"],
    ["uid", "fsck"],
    ["uid"],
]


@pytest.mark.parametrize("writer,reader", [("jax", "jax"), ("port", "port"),
                                           ("jax", "port"), ("port", "jax")])
def test_import_then_reads_alike(tmp_path, capsys, writer, reader):
    """``writer`` imports, ``reader`` runs the reads; every answer equals
    the JAX CLI's on its own JAX-written store."""
    files = _datafile(tmp_path)
    outs = {}
    for key, (w, r) in {"ref": ("jax", "jax"),
                        "got": (writer, reader)}.items():
        wal = str(tmp_path / f"{key}-wal")
        rc, said = run(w, ["import", "--wal", wal, *files], capsys)
        assert rc == 0
        outs[key] = [said] + [run(r, [*a[:1], "--wal", wal, *a[1:]],
                                  capsys) for a in READS]
    ref, got = outs["ref"], outs["got"]
    assert got[0] == ref[0]
    assert "145 points" in ref[0] and "Total: imported 146" in ref[0]
    for args, (rc, out), (wrc, want) in zip(READS, got[1:], ref[1:]):
        assert rc == wrc, args
        same_lines(out, want)
    assert ref[3][1].count("\n") > 10          # the rate query answers


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_tsst4_import_and_read_only_reads_alike(tmp_path, capsys, writer,
                                                reader):
    """``import --sstable-codec tsst4`` spills compressed generations the
    other CLI reads alike, also with ``--read-only``."""
    files = _datafile(tmp_path)
    outs = {}
    for key, w in (("ref", "jax"), ("got", writer)):
        wal = str(tmp_path / f"{key}-wal")
        assert run(w, ["import", "--wal", wal, "--sstable-codec", "tsst4",
                       *files], capsys)[0] == 0
        r = "jax" if key == "ref" else reader
        outs[key] = [run(r, [*a[:1], "--wal", wal, *ro, *a[1:]], capsys)
                     for a in READS[:8] for ro in ([], ["--read-only"])]
    for (rc, out), (wrc, want) in zip(outs["got"], outs["ref"]):
        assert rc == wrc
        same_lines(out, want)


def test_mutations_alike(tmp_path, capsys):
    """assign, rename, mkmetric and scan --delete print alike and leave
    stores that read alike through both CLIs."""
    files = _datafile(tmp_path)
    steps = [["uid", "assign", "metrics", "one", "two"],
             ["uid", "assign", "tagk", "host2"],
             ["uid", "rename", "tagk", "host2", "server"],
             ["uid", "tagk", "server"],
             ["uid", "tagk", "host2"],
             ["mkmetric", "my.metric", "my.other"],
             ["scan", "--delete", str(BT), str(BT + 10), "m.scan"],
             ["query", str(BT), str(BT + 10), "sum", "m.scan"],
             ["uid", "fsck"],
             ["uid", "grep", "metrics", "^my"]]
    outs = {}
    for pkg in ("jax", "port"):
        wal = str(tmp_path / f"{pkg}-wal")
        assert run(pkg, ["import", "--wal", wal, *files], capsys)[0] == 0
        outs[pkg] = [run(pkg, [*s[:1], "--wal", wal, *s[1:]], capsys)
                     for s in steps]
        # The other CLI reads the mutated store alike.
        other = "port" if pkg == "jax" else "jax"
        outs[pkg].append(run(other, ["uid", "--wal", wal, "grep", "."],
                             capsys))
    assert outs["port"] == outs["jax"]
    assert outs["port"][7] == (0, "")


def test_bad_line_raises_in_both(tmp_path, capsys):
    path = tmp_path / "bad.txt"
    path.write_text("not valid\n")
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError) as e:
            run(pkg, ["import", "--wal", str(tmp_path / f"{pkg}-wal"),
                      str(path)], capsys)
        assert "Invalid data at line 1" in str(e.value)


def test_rollup_resolutions_imply_the_tier_alike(tmp_path, capsys):
    files = _datafile(tmp_path)[:1]
    states = {}
    for pkg in ("jax", "port"):
        wal = str(tmp_path / f"{pkg}-wal")
        assert run(pkg, ["import", "--wal", wal, "--rollup-resolutions",
                         "7200,86400", *files], capsys)[0] == 0
        with open(wal + ".rollup.json") as f:
            rec = json.load(f)
        states[pkg] = (rec["resolutions"], rec["pending"])
    assert states["port"] == states["jax"] == ([7200, 86400], False)


def test_query_graph_is_not_yet_ported(tmp_path, capsys):
    rc = port_cli.main(["query", "--device", "cpu", "--wal",
                        str(tmp_path / "w"), "--graph",
                        str(tmp_path / "g"), str(BT), "sum", "m"])
    assert rc == 2
    assert "not yet ported" in capsys.readouterr().err
    assert not (tmp_path / "g.png").exists()


# ---------------------------------------------------------------------------
# ops tools
# ---------------------------------------------------------------------------

def check_args(**kw):
    ns = argparse.Namespace(
        host="127.0.0.1", port=4242, metric="m", tag=[], duration=600,
        downsample="none", downsample_window=60, aggregator="sum",
        comparator="gt", rate=False, warning=None, critical=None,
        no_result_ok=False, ignore_recent=0, timeout=5, verbose=False)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


NOW = 1_700_000_000
LINES = [f"m {NOW - (5 - i) * 10} {v} host=a"
         for i, v in enumerate([1, 2.5, 30, 4, 5])]


@pytest.mark.parametrize("kw", [
    dict(warning=100.0), dict(warning=10.0), dict(critical=10.0),
    dict(warning=3.0, critical=20.0), dict(comparator="lt", warning=2.0),
    dict(comparator="le", critical=1), dict(comparator="eq", warning=4),
    dict(comparator="ne", warning=4), dict(ignore_recent=25, warning=3),
    dict(duration=30, warning=3.0), dict(tag=["host=a|b"], critical=1.0),
    dict(duration=1, warning=1.0), dict(duration=1, warning=1.0,
                                        no_result_ok=True)])
def test_evaluate_check_alike(kw):
    got = port_ops.evaluate_check(check_args(**kw), LINES, NOW)
    assert got == jax_ops.evaluate_check(check_args(**kw), LINES, NOW)


@pytest.mark.parametrize("kw", [
    dict(metric="sys.cpu.user"),
    dict(metric="m", tag=["host=a", "dc=b"], downsample="avg",
         downsample_window=120, rate=True, aggregator="max", duration=60)])
def test_check_query_path_alike(kw):
    assert port_ops.check_query_path(check_args(**kw)) == \
        jax_ops.check_query_path(check_args(**kw))


def test_ratio_and_skew_lines_alike():
    num = ["a 100 8", "a 200 0", "a 300 5", "a 100 3 host=y", "bad"]
    den = ["b 100 2", "b 200 0", "b 400 7", "b 100 6 host=y"]
    for total in (False, True):
        assert port_ops.ratio_lines(num, den, "r", total) == \
            jax_ops.ratio_lines(num, den, "r", total)
    lines = ["e 100 3 host=a", "e 100 5 host=b", "e 200 4 host=a", "x"]
    assert port_ops.skew_lines(lines, "s") == jax_ops.skew_lines(lines, "s")


def _live(pkg):
    """A daemon of ``pkg`` on its own thread with two series over the
    last minute: (server, stop)."""
    base = dict(auto_create_metrics=True, port=0, bind="127.0.0.1",
                enable_sketches=False, device_window=False)
    if pkg == "jax":
        tsdb = JaxTSDB(JaxStore(), JaxConfig(**base),
                       start_compaction_thread=False)
        server = JaxServer(tsdb)
    else:
        tsdb = TSDB(MemKVStore(), Config(device="cpu", **base),
                    start_compaction_thread=False)
        server = TSDServer(tsdb)
    now = int(time.time())
    for i in range(5):
        tsdb.add_point("sys.load", now - 60 + i * 10, 10.0 * (i + 1),
                       {"host": "a"})
        tsdb.add_point("q.hit", now - 60 + i * 10, 9, {"host": "a"})
        tsdb.add_point("q.miss", now - 60 + i * 10, 1, {"host": "a"})
    started = threading.Event()
    holder = {}

    def serve():
        async def main():
            await server.start()
            holder["loop"] = asyncio.get_running_loop()
            holder["stop"] = asyncio.Event()
            started.set()
            await holder["stop"].wait()
            await server.stop()
        asyncio.run(main())

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    assert started.wait(10)

    def stop():
        holder["loop"].call_soon_threadsafe(holder["stop"].set)
        t.join(10)
    return server, stop


CHECKS = [dict(metric="sys.load", critical=45.0, duration=300),
          dict(metric="sys.load", critical=1000.0, duration=300),
          dict(metric="sys.load", warning=5.0, critical=60.0,
               duration=300, downsample="avg", downsample_window=30),
          dict(metric="nope.metric", critical=1.0),
          dict(metric="q.hit", comparator="lt", critical=0.95,
               duration=300, divide_by="q.miss", ratio_total=True),
          dict(metric="sys.load", comparator="gt", critical=0,
               duration=300, tag=["host=*"], skew=True),
          dict(stats_metric="tsd.connectionmgr.exceptions", critical=0),
          dict(stats_metric="tsd.no.such.line", critical=1,
               no_result_ok=True),
          dict(critical=None)]


def test_check_against_both_daemons_alike(capsys):
    answers = {}
    for daemon in ("jax", "port"):
        server, stop = _live(daemon)
        try:
            for tool in (jax_ops, port_ops):
                for kw in CHECKS:
                    args = check_args(port=server.port, **kw)
                    capsys.readouterr()
                    rv = tool.cmd_check(copy.copy(args))
                    out = capsys.readouterr()
                    answers.setdefault((daemon, json.dumps(kw)), []).append(
                        (rv, out.out, out.err))
        finally:
            stop()
    for key, (j, p) in answers.items():
        assert p == j, key
    rvs = [answers[("port", json.dumps(kw))][1][0] for kw in CHECKS]
    assert rvs == [2, 0, 1, 2, 2, 0, 0, 0, 2]
    # Both daemons answer the /q checks alike too.
    for kw in CHECKS[:6]:
        assert answers[("port", json.dumps(kw))][1][0] == \
            answers[("jax", json.dumps(kw))][1][0]


def test_drain_alike(tmp_path):
    files = {}
    for name, tool in (("jax", jax_ops), ("port", port_ops)):
        d = str(tmp_path / name)
        server = tool.DrainServer(d, bind="127.0.0.1", port=0)

        async def main():
            await server.start()
            try:
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", server.port)
                writer.write(b"version\n")
                await writer.drain()
                said = await asyncio.wait_for(reader.readline(), 5)
                writer.write(b"put m 1 2 host=a\ngarbage line\n"
                             b"put m 2 3 host=a\n")
                await writer.drain()
                writer.close()
                await writer.wait_closed()
                await asyncio.sleep(0.1)
                return said
            finally:
                await server.stop()

        said = asyncio.run(main())
        files[name] = (said, server.lines_drained, {
            f: open(os.path.join(d, f)).read() for f in os.listdir(d)})
    assert files["port"] == files["jax"]
    assert files["port"][2] == {"127.0.0.1": "m 1 2 host=a\nm 2 3 host=a\n"}


@pytest.mark.parametrize("threshold,min_age", [(101.0, 0.0), (0.0, 0.0),
                                               (0.0, 60.0)])
def test_clean_cache_alike(tmp_path, threshold, min_age):
    kept = {}
    for name, tool in (("jax", jax_ops), ("port", port_ops)):
        d = tmp_path / name
        d.mkdir()
        (d / "fresh.txt").write_bytes(b"d")
        (d / "old.json").write_bytes(b"d")
        (d / "sub").mkdir()
        past = time.time() - 3600
        os.utime(d / "old.json", (past, past))
        removed = tool.clean_cache(str(d), threshold_pct=threshold,
                                   min_age=min_age)
        kept[name] = (removed, sorted(os.listdir(d)))
    assert kept["port"] == kept["jax"]
    assert port_ops.clean_cache(str(tmp_path / "nope")) == 0


def test_ops_subcommands_parse_alike(capsys):
    """The port CLI's ops parsers take the JAX CLI's flags."""
    for argv in (["check", "-m", "m", "-w", "1", "-x", "lt", "-D", "avg",
                  "-W", "30", "-r", "-E", "-I", "5", "-R", "d",
                  "--ratio-total"],
                 ["drain", "--port", "0", "somewhere"],
                 ["clean-cache", "--threshold", "50", "--min-age", "5",
                  "dir"]):
        got = port_cli.build_parser().parse_args(argv)
        assert got.func.__name__ == {"check": "cmd_check",
                                     "drain": "cmd_drain",
                                     "clean-cache": "cmd_clean_cache"}[
            argv[0]]
        assert got.func.__module__ == "opentsdb_tpu_torch.tools.ops"


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_sharded_store_alike(tmp_path, capsys, writer, reader):
    """``import --shards 4`` makes the manifest and shard directories;
    later commands take the count from it, a disagreeing explicit count
    (1 included) is the same hard error, and both CLIs read the store
    alike."""
    lines = [f"sh.metric {BT + i * 10} {i} host=web{i % 4:02d}"
             for i in range(40)]
    path = tmp_path / "data.txt"
    path.write_text("\n".join(lines) + "\n")
    d = str(tmp_path / "store")
    assert run(writer, ["import", "--wal", d, "--shards", "4",
                        str(path)], capsys)[0] == 0
    assert os.path.exists(os.path.join(d, "SHARDS.json"))
    assert sorted(n for n in os.listdir(d) if n.startswith("shard-")) \
        == [f"shard-{i}" for i in range(4)]
    reads = [["query", "--wal", d, str(BT), str(BT + 400), "sum",
              "sh.metric"],
             ["query", "--wal", d, str(BT), str(BT + 400), "sum",
              "sh.metric", "host=*"],
             ["scan", "--wal", d, "--import", str(BT), "sh.metric"]]
    got = [run(reader, a, capsys) for a in reads]
    want = [run(writer, a, capsys) for a in reads]
    assert got == want
    assert len(got[0][1].splitlines()) == 40
    for n in ("2", "1"):
        errs = []
        for pkg in ("jax", "port"):
            with pytest.raises(ValueError, match="shard-count mismatch") \
                    as e:
                run(pkg, ["query", "--wal", d, "--shards", n, str(BT),
                          "sum", "sh.metric"], capsys)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
