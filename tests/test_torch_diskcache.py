"""The port's /q disk cache and static pages (opentsdb_tpu_torch/server/
tsd.py) against the JAX daemon's, each daemon on loopback over the same
points (device="cpu"): the scenarios of tests/test_server.py through both.

Contracts:
- a repeat /q is served from the cache file named by the md5 of the query
  string plus .txt / .json (the same names in both cache directories), the
  body byte for byte the first's, the hit and miss counters and the
  http.graph.requests{cache=} lines equal; an empty answer is a negative
  hit; nocache, trace=1 and a degraded request bypass it; an empty .json
  is regenerated; the .meta sidecar's headers survive a hit;
- a cache directory written by one daemon serves the other;
- the freshness rules: a day for a query that ended more than a day ago,
  a minute for a relative end, five minutes otherwise, a replica's
  staleness bound below those;
- / and /s/: the packaged UI (the JAX file byte for byte), a staticroot
  file, the .. refusal and a missing file answered alike, with the same
  content types and Cache-Control; a staticroot index.html overrides the
  packaged page; /dropcaches answers alike.
"""

import asyncio
import hashlib
import os
import time

import numpy as np
import pytest

from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.server.tsd import TSDServer as JaxServer
from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config

BT = 1356998400


def _open(pkg, root, **kw):
    """(server, tsdb) of ``pkg`` with its cache and static directories
    under ``root``."""
    cache = kw.pop("cachedir", str(root / "cache"))
    static = root / "static"
    static.mkdir(parents=True, exist_ok=True)
    (static / "hello.txt").write_text("hi\n")
    (static / "app.js").write_text("var x = 1;\n")
    base = dict(auto_create_metrics=True, port=0, bind="127.0.0.1",
                cachedir=cache, staticroot=str(static),
                enable_sketches=False, device_window=False, **kw)
    if pkg == "jax":
        tsdb = JaxTSDB(JaxStore(), JaxConfig(**base),
                       start_compaction_thread=False)
        return JaxServer(tsdb), tsdb
    tsdb = TSDB(MemKVStore(), Config(device="cpu", **base),
                start_compaction_thread=False)
    return TSDServer(tsdb), tsdb


async def _get(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nHost: x\r\n"
                 "Connection: close\r\n\r\n".encode())
    await writer.drain()
    data = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    hdrs = dict(ln.split(": ", 1) for ln in lines[1:] if ": " in ln)
    return int(lines[0].split()[1]), hdrs, body


def _serve(server, drive):
    async def main():
        await server.start()
        try:
            return await drive(server.port)
        finally:
            await server.stop()
    return asyncio.run(main())


def _both(tmp_path, build, drive, **kw):
    """``build(tsdb)`` then ``drive(port)`` on each daemon: {pkg: (what
    drive returned, server)}."""
    out = {}
    for pkg in ("jax", "port"):
        server, tsdb = _open(pkg, tmp_path / pkg, **kw)
        build(tsdb)
        out[pkg] = (_serve(server, drive), server)
    return out


def _points(tsdb):
    tsdb.add_batch("m.x", np.arange(BT, BT + 60, 10),
                   np.array([1, 2, 3, 4, 5, 6]), {"host": "a"})
    tsdb.add_batch("m.x", np.arange(BT + 5, BT + 65, 10),
                   np.array([1.5, 2.5, 3.5, 4.5, 5.5, 6.5]), {"host": "b"})
    tsdb.metrics.get_or_create_id("m.empty")


def _md5(qs):
    return hashlib.md5(qs.encode()).hexdigest()


def _stat(server, name):
    """The ``name`` lines of /stats, less their timestamps."""
    return [ln.split(" ", 2)[0] + " " + ln.split(" ", 2)[2]
            for ln in server._collect_stats() if name in ln]


@pytest.mark.parametrize("fmt", ["ascii", "json"])
def test_repeat_query_is_a_hit_alike(tmp_path, fmt):
    qs = f"start={BT}&end={BT + 100}&m=sum:m.x%7Bhost=*%7D&{fmt}"

    async def drive(port):
        return await _get(port, "/q?" + qs), await _get(port, "/q?" + qs)

    out = _both(tmp_path, _points, drive)
    bodies = {}
    for pkg, ((first, second), server) in out.items():
        assert first[0] == second[0] == 200
        assert first[2] == second[2]
        assert first[1]["Content-Type"] == second[1]["Content-Type"]
        assert (server.cache_hits, server.cache_misses) == (1, 1)
        suffix = ".txt" if fmt == "ascii" else ".json"
        assert os.listdir(tmp_path / pkg / "cache") == [_md5(qs) + suffix]
        bodies[pkg] = first[2]
    if fmt == "ascii":
        assert bodies["port"] == bodies["jax"]
    assert _stat(out["port"][1], "http.graph.requests") == \
        _stat(out["jax"][1], "http.graph.requests")
    assert out["port"][0][0][1]["Content-Type"] == \
        out["jax"][0][0][1]["Content-Type"]


def test_negative_cache_and_bypasses_alike(tmp_path):
    empty = f"/q?start={BT}&end={BT + 10}&m=sum:m.empty&ascii"
    q = f"/q?start={BT}&end={BT + 100}&m=sum:m.x&json"

    async def drive(port):
        return [await _get(port, t) for t in (
            empty, empty,                       # negative hit
            q + "&nocache", q + "&nocache",     # never cached
            q + "&trace=1", q + "&trace=1",     # traced: bypass
            q + "&degrade=rollup-only")]

    out = _both(tmp_path, _points, drive)
    counts = {}
    for pkg, (res, server) in out.items():
        assert [r[0] for r in res[:6]] == [200] * 6
        assert res[0][2] == res[1][2] == b""
        counts[pkg] = (server.cache_hits, server.cache_misses,
                       res[6][0], sorted(os.listdir(tmp_path / pkg
                                                    / "cache")))
    assert counts["port"] == counts["jax"]
    assert counts["port"][:2] == (1, 6)
    assert counts["port"][3] == [_md5(empty[3:]) + ".txt"]


def test_empty_json_is_regenerated_and_meta_survives_alike(tmp_path):
    qs = f"start={BT}&end={BT + 100}&m=sum:m.x&json"
    metas = {}
    for pkg in ("jax", "port"):
        server, tsdb = _open(pkg, tmp_path / pkg)
        _points(tsdb)
        path = tmp_path / pkg / "cache" / (_md5(qs) + ".json")
        path.write_bytes(b"")
        (tmp_path / pkg / "cache" / (_md5(qs) + ".json.meta")).write_text(
            '{"X-Tsd-Approx": "digest;rel_error=0.01"}')

        async def drive(port):
            a = await _get(port, "/q?" + qs)
            b = await _get(port, "/q?" + qs)
            return a, b

        a, b = _serve(server, drive)
        assert a[2] and a[2] == b[2] and path.read_bytes() == a[2]
        assert (server.cache_hits, server.cache_misses) == (1, 1)
        metas[pkg] = (a[1].get("X-Tsd-Approx"), b[1].get("X-Tsd-Approx"))
    # The regenerated answer carries no approx header; the stale sidecar
    # (no new one was written) still rides the hit.
    assert metas["port"] == metas["jax"] == (
        None, "digest;rel_error=0.01")


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_a_cache_directory_serves_the_other_daemon(tmp_path, writer,
                                                   reader):
    """The reader holds no points at all: its answers come from the
    writer's files."""
    shared = str(tmp_path / "shared")
    targets = [f"/q?start={BT}&end={BT + 100}&m=sum:m.x%7Bhost=*%7D&ascii",
               f"/q?start={BT}&end={BT + 100}&m=sum:m.x&json"]

    async def drive(port):
        return [await _get(port, t) for t in targets]

    server, tsdb = _open(writer, tmp_path / writer, cachedir=shared)
    _points(tsdb)
    wrote = _serve(server, drive)
    server, _ = _open(reader, tmp_path / reader, cachedir=shared)
    read = _serve(server, drive)
    assert [r[2] for r in read] == [w[2] for w in wrote]
    assert [r[1]["Content-Type"] for r in read] == \
        [w[1]["Content-Type"] for w in wrote]
    assert (server.cache_hits, server.cache_misses) == (2, 0)


@pytest.mark.parametrize("end,age,fresh", [
    (BT + 100, 3600, True),                  # ended long ago: a day
    (BT + 100, 90000, False),
    ("now", 200, True),                      # absolute, recent: 5 min
    ("now", 400, False),
    ("1m-ago", 30, True),                    # relative: a minute
    ("1m-ago", 90, False)])
def test_freshness_rules_alike(tmp_path, end, age, fresh):
    now = int(time.time())
    end_ts = now if end in ("now", "1m-ago") else end
    # An absolute end= names its second; a relative one (or none) not.
    q = {"end": end if end == "1m-ago" else str(end_ts)}
    for pkg in ("jax", "port"):
        server, tsdb = _open(pkg, tmp_path / pkg)
        path = tmp_path / pkg / "f.txt"
        path.write_text("x")
        os.utime(path, (now - age, now - age))
        assert server._cache_fresh(str(path), q, end_ts, now) is fresh
        tsdb.shutdown()


def test_replica_staleness_bound_caps_freshness_alike(tmp_path):
    now = int(time.time())
    for pkg in ("jax", "port"):
        server, tsdb = _open(pkg, tmp_path / pkg, max_staleness_ms=2000.0)
        server.tailer = object()
        path = tmp_path / pkg / "f.txt"
        path.write_text("x")
        os.utime(path, (now - 5, now - 5))
        assert server._cache_fresh(str(path), {}, BT, now) is False
        os.utime(path, (now - 1, now - 1))
        assert server._cache_fresh(str(path), {}, BT, now) is True
        tsdb.shutdown()


def test_static_pages_alike(tmp_path):
    targets = ["/", "/s/index.html", "/s", "/s/hello.txt", "/s/app.js",
               "/s/../secret", "/s/nope.txt", "/dropcaches"]

    async def drive(port):
        return [await _get(port, t) for t in targets]

    out = _both(tmp_path, lambda t: None, drive)
    jax_res, port_res = out["jax"][0], out["port"][0]
    for t, j, p in zip(targets, jax_res, port_res):
        assert p[0] == j[0], t
        assert p[2] == j[2], t
        for h in ("Content-Type", "Cache-Control"):
            assert p[1].get(h) == j[1].get(h), (t, h)
    home = port_res[0]
    assert home[0] == 200 and b"metric-template" in home[2]
    assert home[1]["Cache-Control"] == "no-cache"
    assert port_res[3][1]["Cache-Control"] == "max-age=31536000"
    assert port_res[5][0] == port_res[6][0] == 404


def test_staticroot_index_overrides_the_packaged_page(tmp_path):
    bodies = {}
    for pkg in ("jax", "port"):
        server, _ = _open(pkg, tmp_path / pkg)
        (tmp_path / pkg / "static" / "index.html").write_text(
            "<html>custom</html>")

        async def drive(port):
            return await _get(port, "/")

        st, hdrs, bodies[pkg] = _serve(server, drive)
        assert st == 200 and hdrs["Cache-Control"] == "no-cache"
    assert bodies["port"] == bodies["jax"] == b"<html>custom</html>"


def test_png_still_not_ported_and_never_cached(tmp_path):
    server, tsdb = _open("port", tmp_path / "port")
    _points(tsdb)

    async def drive(port):
        return await _get(port, f"/q?start={BT}&end={BT + 100}&m=sum:m.x")

    st, _, body = _serve(server, drive)
    assert st == 400 and b"not yet ported" in body
    assert os.listdir(tmp_path / "port" / "cache") == []
