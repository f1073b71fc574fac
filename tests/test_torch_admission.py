"""The query half of admission on the port's ``/q`` (ROADMAP item 10b)
against the JAX daemon.

One script of requests goes to a JAX and a port daemon over rollup tiers
built from the same seeded ingest (test_torch_rollup's corpus: the first
day and a half checkpointed, the rest in the memtable, so later windows
are dirty), each request made at a set rung of the ladder
(``Config.query_max_inflight`` N = 2: the in-flight count set before it):
full service, the degraded step (a moment downsample from the tier alone,
a percentile downsample from the sketch columns, a raw-only query's 503,
trace work shed, a sketch answer over ``degrade_max_error``'s budget), a
router's ``?degrade=rollup-only`` at no load, the load shed, and a dry
per-tenant ``query_rate`` bucket. Statuses, the ``Retry-After``,
``X-Tsd-Degraded`` and ``X-Tsd-Approx`` headers and the bodies (byte for
byte where they are text; keys, tags, tags of degradation and approx
infos, and values within float tolerance where they are JSON) equal the
JAX daemon's; each degraded percentile bucket lies within its reported
bound of the exact answer; the admission counters of ``/stats`` and
``/api/queries`` agree."""

import asyncio
import json

import numpy as np
import pytest

from opentsdb_tpu.server.tsd import TSDServer as JaxServer
from opentsdb_tpu_torch.server.tsd import TSDServer
from test_torch_rollup import BASE, END, METRIC, ingest, jax_tsdb, port_tsdb

M = METRIC
Q = f"/q?start={BASE}&end={END}&json"
# (label, in-flight queries before the request, config overrides, target)
SCRIPT = [
    ("ok-moment", 0, {}, f"{Q}&m=sum:1h-avg:{M}"),
    ("ok-pct", 0, {}, f"{Q}&m=max:1h-p95:{M}"),
    ("ok-raw", 0, {}, f"{Q}&m=sum:{M}"),
    ("deg-moment", 2, {}, f"{Q}&m=sum:1h-avg:{M}"),
    ("deg-moment-dc", 3, {}, f"{Q}&m=avg:1d-max:{M}%7Bdc=*%7D"),
    ("deg-pct", 2, {}, f"{Q}&m=max:1h-p95:{M}"),
    ("deg-pct-1d", 2, {}, f"{Q}&m=sum:1d-p99:{M}"),
    ("deg-raw", 2, {}, f"{Q}&m=sum:{M}"),
    ("deg-rate", 2, {}, f"{Q}&m=sum:rate:1h-avg:{M}"),
    ("deg-trace", 2, {}, f"{Q}&m=sum:1h-avg:{M}&trace=1"),
    ("deg-ascii", 2, {}, f"/q?start={BASE}&end={END}&ascii"
                         f"&m=sum:1d-avg:{M}"),
    ("deg-budget", 2, {"degrade_max_error": 1e-9},
     f"{Q}&m=max:1h-p95:{M}"),
    ("router-asks", 0, {}, f"{Q}&m=max:1h-p95:{M}&degrade=rollup-only"),
    ("router-asks-raw", 0, {}, f"{Q}&m=sum:{M}&degrade=rollup-only"),
    ("shed-load", 4, {}, f"{Q}&m=sum:1h-avg:{M}"),
    ("quota-1", 0, {"query_rate": 0.001, "query_burst": 1.0},
     f"{Q}&m=sum:1h-avg:{M}&tenant=t1"),
    ("quota-2", 0, {}, f"{Q}&m=sum:1h-avg:{M}&tenant=t1"),
    ("quota-other", 0, {}, f"{Q}&m=sum:1h-avg:{M}&tenant=t2"),
    ("stats", 0, {"query_rate": 0.0}, "/stats?json"),
    ("queries", 0, {}, "/api/queries"),
]
HEADERS = ("retry-after", "x-tsd-degraded", "x-tsd-approx", "content-type")


async def _get(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nConnection: close\r\n\r\n"
                 .encode())
    await writer.drain()
    data = await asyncio.wait_for(reader.read(), 60)
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    hdrs = {k.lower(): v for k, v in
            (ln.split(": ", 1) for ln in lines[1:])}
    return int(lines[0].split()[1]), hdrs, body


def _run(server):
    async def main():
        await server.start()
        try:
            out = {}
            for label, inflight, over, target in SCRIPT:
                for k, v in over.items():
                    setattr(server.config, k, v)
                server.admission.inflight_queries = inflight
                out[label] = await _get(server.port, target)
                assert server.admission.inflight_queries == inflight, label
                server.admission.inflight_queries = 0
                server.config.degrade_max_error = 0.0
            return out
        finally:
            await server.stop()
    return asyncio.run(main())


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    base = tmp_path_factory.mktemp("ladder")
    out = {}
    for name, open_fn, server in (("jax", jax_tsdb, JaxServer),
                                  ("port", port_tsdb, TSDServer)):
        t = open_fn(str(base / name), port=0, bind="127.0.0.1",
                    query_max_inflight=2)
        try:
            ingest(t, 0)
            t.checkpoint()
            # The rest stays in the memtable: windows past a day and a
            # half are dirty (the day-1 window folded, then written again).
            ingest(t, 1)
            out[name] = _run(server(t))
        finally:
            t.shutdown()
    return out["jax"], out["port"]


def _dps(ent):
    return np.array(list(ent["dps"].values()))


@pytest.mark.parametrize("label", [s[0] for s in SCRIPT[:-2]])
def test_ladder_matches_the_jax_daemon(ladder, label):
    want, got = ladder
    (gs, gh, gb), (ws, wh, wb) = got[label], want[label]
    assert gs == ws, (label, gb, wb)
    for h in HEADERS:
        assert gh.get(h) == wh.get(h), (label, h)
    if gs != 200 or label == "deg-ascii":
        assert gb == wb, label
        return
    g, w = json.loads(gb), json.loads(wb)
    assert len(g) == len(w) > 0, label
    for ge, we in zip(g, w):
        assert list(ge) == list(we), label
        for k in ("metric", "tags", "aggregateTags", "rollup", "cached",
                  "degraded"):
            assert ge.get(k) == we.get(k), (label, k)
        assert list(ge["dps"]) == list(we["dps"]), label
        np.testing.assert_allclose(_dps(ge), _dps(we), rtol=1e-6,
                                   err_msg=label)
        if "approx" in we:
            ga, wa = ge["approx"], we["approx"]
            assert ga.keys() == wa.keys(), label
            for k, v in wa.items():
                if isinstance(v, float):
                    np.testing.assert_allclose(ga[k], v, rtol=1e-9)
                else:
                    assert ga[k] == v, (label, k)


def test_ladder_rungs(ladder):
    """What each rung answers (the port's side; the JAX daemon's is held
    equal above)."""
    _, got = ladder
    for label in ("ok-moment", "ok-pct", "ok-raw"):
        s, h, b = got[label]
        assert s == 200 and "x-tsd-degraded" not in h
        assert all("degraded" not in e for e in json.loads(b))
    for label in ("deg-moment", "deg-moment-dc", "deg-pct", "deg-pct-1d",
                  "deg-trace", "router-asks"):
        s, h, b = got[label]
        assert s == 200, (label, b)
        assert h["x-tsd-degraded"] == "rollup-only", label
        res = json.loads(b)
        assert all(e["degraded"] == "rollup-only" for e in res), label
        assert all("trace" not in e for e in res), label
    # The degraded moment answer over dirty windows declares them.
    ap = json.loads(got["deg-moment"][2])[0]["approx"]
    assert ap["kind"] == "rollup-stale" and ap["error"] is None
    assert ap["stale_windows"] + ap["omitted_edges"] + \
        ap["missing_windows"] > 0
    assert json.loads(got["deg-moment"][2])[0]["rollup"] == "1h"
    # The percentile from the sketch columns, its bound declared.
    for label in ("deg-pct", "deg-pct-1d", "router-asks"):
        s, h, b = got[label]
        assert h["x-tsd-approx"].split(";")[0] in ("moment", "tdigest")
        for e in json.loads(b):
            assert e["rollup"].startswith("approx-")
            assert isinstance(e["approx"]["error"], float)
    for label in ("deg-raw", "deg-rate", "deg-budget", "router-asks-raw",
                  "shed-load"):
        s, h, b = got[label]
        assert s == 503 and h["retry-after"] == "1", label
    assert got["deg-raw"][2].startswith(b"shedding load: this query needs "
                                        b"a raw scan")
    assert got["deg-budget"][2].startswith(b"shedding load: no approximate")
    assert got["shed-load"][2] == (b"shedding load: too many queries in "
                                   b"flight\n")
    assert got["quota-1"][0] == 200 and got["quota-other"][0] == 200
    s, h, b = got["quota-2"]
    assert s == 429 and int(h["retry-after"]) >= 1
    assert b == b"query quota exceeded for tenant 't1'\n"


def test_degraded_percentile_within_its_bound(ladder):
    """Each bucket of the degraded percentile answer lies within its
    reported bound of the exact answer over the same range."""
    _, got = ladder
    exact = json.loads(got["ok-pct"][2])[0]
    assert "approx" not in exact
    for label in ("deg-pct", "router-asks"):
        deg = json.loads(got[label][2])[0]
        err = deg["approx"]["error"]
        assert deg["dps"], label
        for ts, v in deg["dps"].items():
            assert ts in exact["dps"], (label, ts)
            assert abs(v - exact["dps"][ts]) <= err * (1 + 1e-9) + 1e-9, \
                (label, ts)


def test_admission_counters_match(ladder):
    want, got = ladder

    def admission(stats):
        return sorted(ln for ln in json.loads(stats[2])
                      if ln.startswith("tsd.admission."))

    strip = [" ".join(ln.split()[:1] + ln.split()[2:])
             for ln in admission(got["stats"])]
    assert strip == [" ".join(ln.split()[:1] + ln.split()[2:])
                     for ln in admission(want["stats"])]
    gq, wq = json.loads(got["queries"][2]), json.loads(want["queries"][2])
    assert gq["admission"] == wq["admission"]
    assert gq["admission"]["degraded"] == 9  # the ladder's, not ?degrade=
    assert gq["admission"]["shed_load"] == 1
    assert gq["plans"] == wq["plans"]
