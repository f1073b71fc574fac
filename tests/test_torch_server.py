"""The port's daemon on loopback (device="cpu"): telnet puts in, /q out,
checked against the JAX package's executor over the same points."""

import asyncio
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BT = 1356998400
START, END = BT, BT + 2 * 3600


def _points(seed=3):
    rng = np.random.default_rng(seed)
    pts = []
    for host in ("a", "b", "c"):
        ts = np.sort(rng.choice(2 * 3600, 150, replace=False)) + BT
        for t, v in zip(ts.tolist(), rng.normal(20, 4, 150).tolist()):
            pts.append((t, round(v, 3), host))
    return pts


def _lines(pts):
    return [f"put sys.load {t} {v} host={h} dc=x" for t, v, h in pts]


async def _telnet(port, lines, first_alone=False):
    """Send ``lines``, then ``version`` and ``exit``; everything the
    daemon answered. ``first_alone`` sends the first line by itself, so
    it takes the per-line path instead of the pipelined bulk path."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    if first_alone:
        writer.write((lines[0] + "\n").encode())
        await writer.drain()
        await asyncio.sleep(0.2)
        lines = lines[1:]
    writer.write(("\n".join(lines) + "\n").encode())
    writer.write(b"version\nexit\n")
    await writer.drain()
    out = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    return out.decode()


async def _get(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nConnection: close\r\n\r\n"
                 .encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


def _serve(drive):
    tsdb = TSDB(MemKVStore(),
                Config(auto_create_metrics=True, device="cpu", port=0,
                       bind="127.0.0.1"),
                start_compaction_thread=False)
    server = TSDServer(tsdb)

    async def main():
        await server.start()
        try:
            return await drive(server.port)
        finally:
            await server.stop()
    return asyncio.run(main())


def _jax_answer(pts, spec):
    jt = JaxTSDB(JaxStore(), JaxConfig(device_window=False,
                                       enable_sketches=False,
                                       auto_create_metrics=True),
                 start_compaction_thread=False)
    try:
        for t, v, h in pts:
            jt.add_point("sys.load", t, v, {"host": h, "dc": "x"})
        return JaxExecutor(jt, backend="tpu").run(spec, START, END)
    finally:
        jt.shutdown()


def test_telnet_puts_then_query_ascii_and_json():
    pts = _points()
    lines = _lines(pts)

    async def drive(port):
        # One line on its own (the per-line path), the rest as one
        # pipelined burst (the columnar bulk path), one bad line inside.
        said = await _telnet(port, lines[:200] + ["put sys.load x 1 a=b"]
                             + lines[200:], first_alone=True)
        q = f"/q?start={START}&end={END}&m=sum:10m-avg:sys.load%7Bhost=*%7D"
        return (said, await _get(port, q + "&ascii"),
                await _get(port, q + "&json"))

    said, (st_a, ascii_body), (st_j, json_body) = _serve(drive)
    assert "opentsdb_tpu_torch" in said
    assert said.count("put: illegal argument") == 1
    assert st_a == 200 and st_j == 200
    want = _jax_answer(pts, JaxSpec("sys.load", {"host": "*"}, "sum",
                                    downsample=(600, "avg")))
    got_json = json.loads(json_body)
    assert [g["tags"] for g in got_json] == [w.tags for w in want]
    rows = [ln.split() for ln in ascii_body.decode().splitlines()]
    k = 0
    for w, g in zip(want, got_json):
        assert list(g["dps"]) == [str(t) for t in w.timestamps]
        # float32 sums in another order: rtol 1e-5.
        np.testing.assert_allclose(list(g["dps"].values()), w.values,
                                   rtol=1e-5)
        for t, v in zip(w.timestamps, w.values):
            assert rows[k][:2] == ["sys.load", str(t)]
            assert rows[k][3:] == ["dc=x", f"host={w.tags['host']}"]
            np.testing.assert_allclose(float(rows[k][2]), v, rtol=1e-5)
            k += 1
    assert k == len(rows)


def _start_cli(wal):
    """``python -m opentsdb_tpu_torch.tools.cli tsd`` on loopback with
    device cpu; (process, port) once it says it is ready."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "opentsdb_tpu_torch.tools.cli", "tsd",
         "--port", "0", "--bind", "127.0.0.1", "--wal", wal,
         "--auto-metric", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    assert line.startswith("Ready to serve on 127.0.0.1:"), line
    return proc, int(line.rsplit(":", 1)[1])


def _stop_cli(proc):
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 0


def test_cli_daemon_serves_and_keeps_its_wal(tmp_path):
    """The daemon command: puts acknowledged before a SIGTERM are in the
    WAL and answer the same query after a restart."""
    wal = str(tmp_path / "wal")
    q = f"/q?start={START}&end={END}&m=max:1h-max:sys.load&ascii"
    proc, port = _start_cli(wal)
    try:
        said = asyncio.run(_telnet(port, _lines(_points()[:50])))
        assert "put:" not in said
        status, before = asyncio.run(_get(port, q))
        assert status == 200 and before
    finally:
        _stop_cli(proc)
    proc, port = _start_cli(wal)
    try:
        assert asyncio.run(_get(port, q)) == (200, before)
    finally:
        _stop_cli(proc)


@pytest.mark.parametrize("target,status,text", [
    ("/q?start=1&m=p95:1h-avg:sys.load&ascii", 400, "not yet ported"),
    ("/q?start=1&m=sum:1h-avg:sys.load", 400, "not yet ported"),
    ("/q?start=1&m=sum:1h-avg:nope&ascii", 400, "No such name"),
    ("/sketch?m=sys.load", 400, "not yet ported"),
    ("/aggregators", 200, "mimmax"),
    ("/version", 200, "opentsdb_tpu_torch"),
    ("/nothing", 404, "Not Found"),
])
def test_http_surface(target, status, text):
    async def drive(port):
        await _telnet(port, _lines(_points()[:5]))
        return await _get(port, target)

    got_status, body = _serve(drive)
    assert got_status == status
    assert text in body.decode()
