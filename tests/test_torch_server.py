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


@pytest.mark.parametrize("m,spec", [
    ("p95:10m-avg:sys.load", JaxSpec("sys.load", {}, "p95",
                                     downsample=(600, "avg"))),
    ("p50:sys.load%7Bhost=*%7D", JaxSpec("sys.load", {"host": "*"}, "p50")),
    ("sum:sys.load", JaxSpec("sys.load", {}, "sum")),
])
def test_percentile_and_undownsampled_ascii_match_jax(m, spec):
    """/q answers a percentile group aggregator and a query without a
    downsampler with the JAX answer's lines: same timestamps and tags,
    values within rtol 1e-5 (float32 in another order)."""
    pts = _points()

    async def drive(port):
        await _telnet(port, _lines(pts))
        return await _get(port, f"/q?start={START}&end={END}&m={m}&ascii")

    status, body = _serve(drive)
    assert status == 200
    want = _jax_answer(pts, spec)
    rows = [ln.split() for ln in body.decode().splitlines()]
    assert len(rows) == sum(len(w.timestamps) for w in want) > 0
    k = 0
    for w in want:
        tags = [f"{t}={v}" for t, v in sorted(w.tags.items())]
        for t, v in zip(w.timestamps, w.values):
            assert rows[k][:2] == ["sys.load", str(t)]
            assert rows[k][3:] == tags
            np.testing.assert_allclose(float(rows[k][2]), v, rtol=1e-5)
            k += 1


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
    ("/q?start=1&m=p95:1h-avg:sys.load&ascii", 200, "sys.load 13569"),
    ("/q?start=1&m=sum:1h-avg:sys.load", 400, "not yet ported"),
    ("/q?start=1&m=sum:1h-avg:nope&ascii", 400, "No such name"),
    ("/sketch?m=sys.load", 200, '"series": 1'),
    ("/forecast?start=1&m=sum:1h-avg:sys.load&png", 400, "not yet ported"),
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


# ---------------------------------------------------------------------------
# /sketch and /distinct against the JAX daemon
# ---------------------------------------------------------------------------

SKETCH_TARGETS = [
    "/sketch?m=sys.load",
    "/sketch?m=sys.load%7Bhost=a%7D&q=p5,0.5,p999",
    "/sketch?m=sys.load%7Bhost=a%7Cb%7D&q=0.25",
    f"/sketch?m=sys.load&start={START}&end={END}",
    f"/sketch?m=sys.load%7Bhost=b%7D&start={START}&end={END}&q=p90",
    "/distinct?metric=sys.load&tagk=host",
    "/distinct?metric=sys.load&tagk=dc&stream",
    f"/distinct?metric=sys.load&tagk=host&start={START}&end={END}",
    f"/distinct?metric=sys.load&tagk=host&start={START}&end={END}"
    "&tags=dc=x",
    # The 400s.
    "/sketch",
    "/sketch?m=sys.load&q=p50,abc",
    "/sketch?m=sys.load&q=1.5",
    "/sketch?m=sys.load&end=123",
    "/sketch?m=sys.load&max_error=0",
    "/sketch?m=sys.load&max_error=abc",
    f"/sketch?m=sys.load&start={END}&end={START}",
    "/sketch?m=nope",
    "/sketch?m=sys.load%7Bhost=zzz%7D",
    "/distinct?metric=sys.load",
    "/distinct?metric=sys.load&tagk=host&end=5",
    "/distinct?metric=sys.load&tagk=rack",
    "/distinct?metric=nope&tagk=host",
    f"/distinct?metric=sys.load&tagk=rack&start={START}&end={END}",
]


async def _get_raw(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nConnection: close\r\n\r\n"
                 .encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    hdrs = dict(ln.split(": ", 1) for ln in lines[1:])
    return int(lines[0].split()[1]), hdrs, body


def _sketch_answers(server_cls, tsdb):
    server = server_cls(tsdb)

    async def main():
        await server.start()
        try:
            await _telnet(server.port, _lines(_points()))
            return [await _get_raw(server.port, t) for t in SKETCH_TARGETS]
        finally:
            await server.stop()
    return asyncio.run(main())


def test_sketch_and_distinct_match_jax_daemon():
    """The same puts, then the same /sketch and /distinct requests, to
    both daemons: statuses, error bodies, ranged answers, distinct counts
    and the X-Tsd-Approx header byte-identical; the all-time quantiles
    (merged t-digests) within the t-digest tolerance, rtol 0.02."""
    from opentsdb_tpu.server.tsd import TSDServer as JaxServer
    cfg = dict(auto_create_metrics=True, port=0, bind="127.0.0.1")
    jt = JaxTSDB(JaxStore(), JaxConfig(device_window=False, **cfg),
                 start_compaction_thread=False)
    want = _sketch_answers(JaxServer, jt)
    pt = TSDB(MemKVStore(), Config(device="cpu", **cfg),
              start_compaction_thread=False)
    got = _sketch_answers(TSDServer, pt)
    statuses = []
    for target, (gs, gh, gb), (ws, wh, wb) in zip(SKETCH_TARGETS, got,
                                                  want):
        statuses.append(gs)
        assert gs == ws, target
        assert gh.get("X-Tsd-Approx") == wh.get("X-Tsd-Approx"), target
        if gs == 200 and target.startswith("/sketch") \
                and "start=" not in target:
            g, w = json.loads(gb), json.loads(wb)
            assert g["metric"] == w["metric"]
            assert g["series"] == w["series"]
            assert list(g["quantiles"]) == list(w["quantiles"])
            np.testing.assert_allclose(list(g["quantiles"].values()),
                                       list(w["quantiles"].values()),
                                       rtol=0.02)
        else:
            assert gb == wb, target
    assert statuses.count(200) == 9
    assert json.loads(got[5][2])["distinct"] == 3
    assert json.loads(got[3][2])["rollup"] == "raw"


def _telnet_script_answers(server_cls, tsdb, lines):
    server = server_cls(tsdb)

    async def main():
        await server.start()
        try:
            return await _telnet(server.port, lines)
        finally:
            await server.stop()
    return asyncio.run(main())


def test_telnet_error_replies_under_native_decoders(tmp_path, monkeypatch):
    """A pipelined burst of put lines, malformed ones among them, to the
    JAX daemon with its native decoder built and patched in, and to the
    port's daemon (native by default): the replies are byte-identical, one
    ``put: illegal argument: ...`` line per bad line and none with a line
    number (the native decoder gives none), and both stores hold the same
    rows and UIDs (tags arrive unsorted: the native decoder sorts them)."""
    from opentsdb_tpu.server import wire as jax_wire
    from opentsdb_tpu.server.tsd import TSDServer as JaxServer
    from opentsdb_tpu_torch.server import wire as port_wire
    from test_torch_native import build_jax_native
    _, lib = build_jax_native(str(tmp_path))
    monkeypatch.setattr(jax_wire, "_NATIVE", lib)
    assert port_wire._NATIVE is not None
    good = [f"put sys.load {t} {v} host={h} dc=x" if i % 2 else
            f"put sys.load {t} {v} dc=x host={h}"
            for i, (t, v, h) in enumerate(_points()[:60])]
    bad = ["put sys.load", "put sys.load! 1 1 a=b", f"put sys.load {BT} x a=b",
           f"put sys.load {BT} 1 a", f"put sys.load {BT} 1 a=b a=c",
           f"put sys.load 0 1 a=b", f"put sys.load {BT} nan a=b"]
    lines = good[:20] + bad[:4] + good[20:40] + bad[4:] + good[40:]
    cfg = dict(auto_create_metrics=True, port=0, bind="127.0.0.1")
    jt = JaxTSDB(JaxStore(), JaxConfig(device_window=False, **cfg),
                 start_compaction_thread=False)
    pt = TSDB(MemKVStore(), Config(device="cpu", **cfg),
              start_compaction_thread=False)
    want = _telnet_script_answers(JaxServer, jt, lines)
    got = _telnet_script_answers(TSDServer, pt, lines)
    # Everything before the reply to ``version``, which names the package;
    # that reply has the JAX daemon's two-line shape.
    from test_torch_version import _fields
    (got, got_v), (want, want_v) = (
        (a[:a.index("opentsdb_tpu")], a[a.index("opentsdb_tpu"):])
        for a in (got, want))
    assert got == want
    assert _fields(got_v, "opentsdb_tpu_torch") == _fields(
        want_v, "opentsdb_tpu")
    errs = got.splitlines()
    assert len(errs) == len(bad)
    assert all(ln.startswith("put: illegal argument: ") for ln in errs)
    assert "at line" not in got
    for table in ("tsdb", "tsdb-uid"):
        assert list(pt.store.scan_raw(table, b"", b"")) == \
            list(jt.store.scan_raw(table, b"", b"")), table
    jt.shutdown()
    pt.shutdown()


UNTRACED_TARGETS = [
    f"/q?start={START}&end={END}&m=sum:10m-avg:sys.load%7Bhost=*%7D&json",
    f"/q?start={START}&end={END}&m=max:sys.load&json&trace=0",
    f"/q?start={START}&end={END}&m=sum:10m-avg:sys.load&ascii",
]


def test_untraced_q_has_no_trace_key_and_matches_jax_daemon(monkeypatch):
    """Without ?trace=1 (or with trace=0) a /q answer carries no trace
    key, and its bytes are the JAX daemon's for the same puts (both on
    the float64 oracle, window off, so every float is the same; both on
    the numpy telnet decoder, which keeps the tags' arrival order:
    ROADMAP queue C, reference note 10)."""
    from opentsdb_tpu.server.tsd import TSDServer as JaxServer
    from opentsdb_tpu_torch.server import wire as port_wire
    monkeypatch.setattr(port_wire, "_NATIVE", None)
    cfg = dict(auto_create_metrics=True, port=0, bind="127.0.0.1",
               device_window=False, backend="cpu")

    def answers(server_cls, tsdb):
        server = server_cls(tsdb)

        async def main():
            await server.start()
            try:
                await _telnet(server.port, _lines(_points()))
                return [await _get(server.port, t)
                        for t in UNTRACED_TARGETS]
            finally:
                await server.stop()
        return asyncio.run(main())

    want = answers(JaxServer, JaxTSDB(JaxStore(), JaxConfig(**cfg),
                                      start_compaction_thread=False))
    got = answers(TSDServer, TSDB(MemKVStore(), Config(device="cpu", **cfg),
                                  start_compaction_thread=False))
    assert got == want
    for (st, body), target in zip(got, UNTRACED_TARGETS):
        assert st == 200 and b"trace" not in body, target
    assert all("trace" not in g for g in json.loads(got[0][1]))


# ---------------------------------------------------------------------------
# /forecast against the JAX daemon
# ---------------------------------------------------------------------------

FC_START, FC_END = BT, BT + 4 * 86400 - 1
FC_Q = f"/forecast?start={FC_START}&end={FC_END}"
FC_TARGETS = [
    FC_Q + "&m=sum:1h-avg:fc.m%7Bhost=*%7D&season=24&horizon=12",
    FC_Q + "&m=sum:1h-avg:fc.m%7Bhost=*%7D&horizon=5&alpha=0.5&beta=0.2",
    FC_Q + "&m=max:1h-max:fc.m&m=sum:1h-avg:fc.m%7Bhost=a%7D&season=24"
    "&nsigma=2&gamma=0.3",
    FC_Q + "&m=sum:1h-avg:fc.m%7Bhost=*%7D&model=ewma&alpha=0.2&horizon=3",
    FC_Q + "&m=avg:30m-avg:fc.m&season=48&horizon=48&alpha=1&beta=0",
    # The 400s.
    FC_Q + "&m=sum:1h-avg:fc.m%7Bhost=zzz%7D",
    "/forecast?m=sum:1h-avg:fc.m",
    f"/forecast?start={FC_START}",
    f"{FC_Q}&m=sum:fc.m",
    f"{FC_Q}&m=sum:1h-avg:fc.m&m=sum:30m-avg:fc.m",
    f"{FC_Q}&m=sum:1h-avg:fc.m&horizon=0",
    f"{FC_Q}&m=sum:1h-avg:fc.m&horizon=10001",
    f"{FC_Q}&m=sum:1h-avg:fc.m&horizon=abc",
    f"{FC_Q}&m=sum:1h-avg:fc.m&horizon=inf",
    f"{FC_Q}&m=sum:1h-avg:fc.m&season=-1",
    f"{FC_Q}&m=sum:1h-avg:fc.m&season=10001",
    f"{FC_Q}&m=sum:1h-avg:fc.m&alpha=-0.1",
    f"{FC_Q}&m=sum:1h-avg:fc.m&alpha=1.5",
    f"{FC_Q}&m=sum:1h-avg:fc.m&beta=2",
    f"{FC_Q}&m=sum:1h-avg:fc.m&gamma=-1",
    f"{FC_Q}&m=sum:1h-avg:fc.m&gamma=nan",
    f"{FC_Q}&m=sum:1h-avg:fc.m&nsigma=0.05",
    f"{FC_Q}&m=sum:1h-avg:fc.m&nsigma=1001",
    f"{FC_Q}&m=sum:1h-avg:fc.m&model=arima",
    f"{FC_Q}&m=sum:1h-avg:nope",
    f"/forecast?start={FC_END}&end={FC_START}&m=sum:1h-avg:fc.m",
]


def _fc_lines(seed=5):
    """Three hosts, 4 days at 10-minute steps: a daily cycle, a drift,
    noise, gaps, and one spike on host b."""
    rng = np.random.default_rng(seed)
    lines = []
    for hi, host in enumerate("abc"):
        ts = np.arange(FC_START, FC_END, 600)
        ts = ts[rng.random(len(ts)) > 0.1]
        day = np.sin(2 * np.pi * (ts - FC_START) / 86400)
        v = 40 + 10 * hi + 8 * day + 0.0003 * (ts - FC_START) \
            + rng.normal(0, 1, len(ts))
        if host == "b":
            v[len(v) * 3 // 4] += 150
        lines += [f"put fc.m {t} {round(x, 3)} host={host}"
                  for t, x in zip(ts.tolist(), v.tolist())]
    return lines


def _fc_answers(server_cls, tsdb):
    server = server_cls(tsdb)

    async def main():
        await server.start()
        try:
            await _telnet(server.port, _fc_lines())
            return [await _get_raw(server.port, t) for t in FC_TARGETS]
        finally:
            await server.stop()
    return asyncio.run(main())


def test_forecast_matches_jax_daemon():
    """The same puts, then the same /forecast requests, to both daemons:
    hw with and without a season, ewma, two m= at once;
    the parsed bodies' keys, timestamps and anomaly lists equal, values
    within rtol 1e-5 plus 1e-5 x the answer's scale (float32 on both
    sides, XLA's CPU fusion rounding differently: tests/test_torch_models.py);
    every 400 byte-identical."""
    from opentsdb_tpu.server.tsd import TSDServer as JaxServer
    cfg = dict(auto_create_metrics=True, port=0, bind="127.0.0.1",
               device_window=False, enable_sketches=False)
    want = _fc_answers(JaxServer, JaxTSDB(JaxStore(), JaxConfig(**cfg),
                                          start_compaction_thread=False))
    got = _fc_answers(TSDServer, TSDB(MemKVStore(),
                                      Config(device="cpu", **cfg),
                                      start_compaction_thread=False))
    n_ok = anomalies = 0
    for target, (gs, gh, gb), (ws, wh, wb) in zip(FC_TARGETS, got, want):
        assert gs == ws, (target, gb)
        assert gh.get("Content-Type") == wh.get("Content-Type"), target
        if gs != 200:
            assert gb == wb, target
            continue
        n_ok += 1
        g, w = json.loads(gb), json.loads(wb)
        assert len(g) == len(w), target
        for ge, we in zip(g, w):
            assert list(ge) == list(we), target
            for k in ("metric", "tags", "model"):
                assert ge[k] == we[k], (target, k)
            if "anomalies" in we:
                assert ge["anomalies"] == we["anomalies"], target
                anomalies += len(we["anomalies"])
            scale = max(abs(v) for v in we["fitted"].values())
            for k in ("fitted", "forecast", "upper", "lower"):
                if k not in we:
                    continue
                assert list(ge[k]) == list(we[k]), (target, k)
                np.testing.assert_allclose(
                    list(ge[k].values()), list(we[k].values()),
                    rtol=1e-5, atol=1e-5 * scale, err_msg=f"{target} {k}")
    assert n_ok == 5
    assert anomalies > 0
