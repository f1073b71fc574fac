"""The port's resident-window query path (opentsdb_tpu_torch/ops/kernels.py
chunked window stage and apply + query/executor.py ``_run_devwindow``)
against the JAX package's on the same inputs, and against the port's own
scan path.

Contract (opentsdb_tpu/query/executor.py:16-18 and
opentsdb_tpu/storage/devstore.py): masks and grids bit-identical; count,
min and max exact; float32 sums, means and deviations (the Chan merge of
chunk-local M2 included) within rtol 1e-5, because the port's segment
sums add in another order than XLA's. Values the lerp fill or the rate
derives from those are held to the same rtol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.ops import kernels as jk
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.ops import kernels as tk
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.storage.devstore import DeviceWindow
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config

BT = 1356998400
STAGE_NAMES = ("series_values", "series_mask", "filled", "in_range",
               "presence")

# ---------------------------------------------------------------------------
# Kernel level: window_series_stage_chunks, JAX vs port, one chunk list
# ---------------------------------------------------------------------------

S_PAD, B, INTERVAL, CHUNK = 16, 16, 600, 128
LO, SHIFT = 137, 100          # lo >= shift, as the executor's always is


def _chunk_list(seed=0):
    """Six series appended 10 points at a time, interleaved, cut into
    128-point chunks as the JAX window holds them (the last padded, valid
    False): buckets and series cross chunk boundaries. Some points fall
    outside [LO, HI]."""
    rng = np.random.default_rng(seed)
    parts = []
    clocks = np.zeros(6, np.int64)
    for _ in range(10):
        for s in range(6):
            ts = clocks[s] + np.cumsum(rng.integers(1, 90, 10))
            clocks[s] = ts[-1]
            parts.append((ts, rng.normal(50, 10, 10),
                          np.cumsum(rng.integers(0, 50, 10)) % 400,
                          np.full(10, s)))
    ts, vals, ctr, sid = (np.concatenate(x) for x in zip(*parts))
    n = len(ts)
    pad = -n % CHUNK
    cols = (np.pad(ts, (0, pad)).astype(np.int32),
            np.pad(vals, (0, pad)).astype(np.float32),
            np.pad(ctr, (0, pad)).astype(np.float32),
            np.pad(sid, (0, pad)).astype(np.int32),
            np.arange(n + pad) < n)
    hi = int(ts.max()) - 200
    chunks = [tuple(c[i:i + CHUNK] for c in cols)
              for i in range(0, n + pad, CHUNK)]
    return chunks, hi


def _pick(c, counter):
    """One chunk's (rel_ts, values, sid, valid); the counter case feeds
    the monotone column."""
    ts, vals, ctr, sid, valid = c
    return ts, ctr if counter else vals, sid, valid


def _port_chunks(chunks, counter):
    """The same chunks as the port's window holds them: unpadded
    (rel_ts, values, sid) tensors."""
    out = []
    for c in chunks:
        ts, vals, sid, valid = _pick(c, counter)
        out.append(tuple(torch.from_numpy(x[valid]) for x in (ts, vals, sid)))
    return out


STAGE_CASES = {
    "sum": dict(agg_down="sum"), "avg": dict(agg_down="avg"),
    "dev": dict(agg_down="dev"), "min": dict(agg_down="min"),
    "max": dict(agg_down="max"), "count": dict(agg_down="count"),
    "rate": dict(agg_down="avg", rate=True),
    "counter": dict(agg_down="max", rate=True, counter=True,
                    counter_max=400.0),
}
EXACT = ("min", "max", "count")


def _assert_stage(got, want, exact, what=""):
    for name, g, w in zip(STAGE_NAMES, got, want):
        g, w = g.cpu().numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if w.dtype == bool or (exact and name == "series_values"):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_chunked_stage_matches_jax(case):
    kw = dict(STAGE_CASES[case])
    chunks, hi = _chunk_list()
    counter = kw.get("counter", False)
    assert len(chunks) >= 4

    jax_chunks = [tuple(jnp.asarray(x) for x in _pick(c, counter))
                  for c in chunks]
    common = dict(num_series=S_PAD, num_buckets=B, interval=INTERVAL, **kw)
    want = jk.window_series_stage_chunks(
        jax_chunks, np.int32(LO), np.int32(hi), np.int32(SHIFT), **common)
    got = tk.window_series_stage_chunks(_port_chunks(chunks, counter), LO,
                                        hi, SHIFT, **common)
    _assert_stage(got, want, exact=case in EXACT, what=case)


@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_stage_and_apply_match_jax_window_query(case):
    """The port's chunked stage + window_moment_apply against the JAX
    package's window_query (stage + apply in one call over the
    concatenated columns): group grids, masks and presence."""
    kw = dict(STAGE_CASES[case])
    chunks, hi = _chunk_list(seed=1)
    counter = kw.get("counter", False)
    cols = _pick([np.concatenate(c) for c in zip(*chunks)], counter)
    common = dict(num_series=S_PAD, num_buckets=B, interval=INTERVAL, **kw)
    stage = tk.window_series_stage_chunks(_port_chunks(chunks, counter), LO,
                                          hi, SHIFT, **common)
    include = np.arange(S_PAD) % 3 != 1
    gmap = (np.arange(S_PAD) % 4).astype(np.int32)
    for agg_group, groups in (("sum", 4), ("max", 4), ("dev", 1),
                              ("zimsum", 4)):
        jgv, jgm, jpres = jk.window_query(
            *cols, include, gmap, np.int32(LO), np.int32(hi),
            np.int32(SHIFT), num_groups=groups, agg_group=agg_group,
            **common)
        tgv, tgm = tk.window_moment_apply(
            *stage[:4], torch.from_numpy(include), torch.from_numpy(gmap),
            num_groups=groups, agg_group=agg_group)
        np.testing.assert_array_equal(tgm.numpy(), np.asarray(jgm))
        np.testing.assert_array_equal(stage[4].numpy(), np.asarray(jpres))
        np.testing.assert_allclose(tgv.numpy(), np.asarray(jgv),
                                   rtol=1e-5, atol=1e-5, err_msg=agg_group)


@pytest.mark.parametrize("agg,rate", [
    ("avg", False), ("max", False), ("sum", True), ("count", False),
    ("dev", False)])
def test_window_chunks_match_jax_concat_stage(agg, rate):
    """window_series_stage_chunks over the many small chunks of a port
    window equals the JAX package's window_series_stage over the same
    points concatenated (tests/test_devstore.py:359 holds the JAX
    package's two stages against each other the same way)."""
    dw = DeviceWindow(staging_points=512, max_points=1 << 20,
                      background=False, device="cpu")
    rng = np.random.default_rng(3)
    muid = b"\x00\x00\x01"
    clocks = [1_700_000_000] * 5
    for _ in range(6):
        for s in range(5):
            ts = clocks[s] + np.cumsum(rng.integers(1, 60, 200))
            clocks[s] = int(ts[-1]) + 1
            dw.append(muid, muid + b"\x00\x00\x01" + bytes([1 + s]),
                      ts.astype(np.int64),
                      rng.normal(50, 10, 200).astype(np.float32))
    dw.flush()
    start, end = 1_700_000_000, max(clocks) + 1
    ch = dw.chunk_columns(muid, start, end)
    assert ch is not None and len(ch.chunks) > 3
    cat = [np.concatenate([c[i].numpy() for c in ch.chunks])
           for i in range(3)]
    kw = dict(num_series=16, num_buckets=64, interval=600, agg_down=agg,
              rate=rate)
    a = tk.window_series_stage_chunks(ch.chunks, 0, end - ch.epoch, 0,
                                      **kw)
    b = jk.window_series_stage(*cat, np.ones(len(cat[0]), bool), np.int32(0),
                               np.int32(end - ch.epoch), np.int32(0), **kw)
    _assert_stage(a, b, exact=agg in EXACT, what=agg)


def test_chunk_fold_merge_order_of_signed_zeros():
    """A min/max merged chunk by chunk keeps -0.0 below +0.0, as one
    segment_minmax pass over all points does."""
    sid = torch.zeros(2, dtype=torch.int32)
    ts = torch.tensor([0, 1], dtype=torch.int32)
    for first, second in ((0.0, -0.0), (-0.0, 0.0)):
        chunks = [(ts, torch.tensor([first, first]), sid),
                  (ts, torch.tensor([second, second]), sid)]
        for agg in ("min", "max"):
            sv = tk.window_series_stage_chunks(
                chunks, 0, 10, 0, num_series=1, num_buckets=16,
                interval=60, agg_down=agg)[0]
            assert sv[0, 0].item() == 0.0
            assert torch.signbit(sv[0, 0]).item() == (agg == "min"), \
                (first, second, agg)


# ---------------------------------------------------------------------------
# _shrink_wrap: the clip and the packed mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,b", [(1, 8), (3, 64), (16, 128), (5, 256)])
def test_packbits_byte_identical(g, b):
    mask = np.random.default_rng(g * b).random((g, b)) > 0.4
    got = tk._packbits(torch.from_numpy(mask)).numpy()
    want = np.packbits(mask, axis=1)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("g_out,b_out", [(4, 64), (16, 256)])
def test_shrink_wrap(g_out, b_out):
    """Clipped to (g_out, b_out), mask bit-packed like np.packbits, as
    JAX's _shrink_wrap clips and packs."""
    rng = np.random.default_rng(4)
    gv = (rng.normal(0, 1e5, (16, 256))).astype(np.float32)
    gm = rng.random((16, 256)) > 0.5
    tv, tm = tk._shrink_wrap(torch.from_numpy(gv), torch.from_numpy(gm),
                             g_out, b_out)
    jv, jm = jk._shrink_wrap(gv, gm, g_out, b_out)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tv.numpy(), gv[:g_out, :b_out])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# End to end: JAX TSDB vs port TSDB, both serving from their windows
# ---------------------------------------------------------------------------

MOMENT_SPECS = [
    dict(metric="m.cpu", tags={}, aggregator="sum", downsample=(600, "avg")),
    dict(metric="m.cpu", tags={"host": "*"}, aggregator="avg",
         downsample=(600, "sum")),
    dict(metric="m.cpu", tags={"dc": "east"}, aggregator="max",
         downsample=(300, "max")),
    dict(metric="m.cpu", tags={"host": "h1|h2"}, aggregator="dev",
         downsample=(600, "avg")),
    dict(metric="m.cpu", tags={}, aggregator="sum", rate=True,
         downsample=(600, "avg")),
    dict(metric="m.cpu", tags={}, aggregator="sum", rate=True, counter=True,
         counter_max=2.0**32, downsample=(600, "avg")),
    dict(metric="m.cpu", tags={"host": "*"}, aggregator="zimsum",
         downsample=(600, "sum")),
    dict(metric="m.cpu", tags={"dc": "*", "host": "h3"}, aggregator="min",
         downsample=(600, "min")),
]
PERCENTILE_SPECS = [
    dict(metric="m.cpu", tags={}, aggregator="p95", downsample=(600, "avg")),
    dict(metric="m.cpu", tags={"host": "*"}, aggregator="p95",
         downsample=(600, "avg")),
    dict(metric="m.cpu", tags={"dc": "*"}, aggregator="p50", rate=True,
         downsample=(600, "avg")),
    dict(metric="m.cpu", tags={"dc": "*"}, aggregator="p99",
         downsample=(300, "max")),
    dict(metric="m.cpu", tags={"host": "*"}, aggregator="p50",
         downsample=(600, "sum")),
    dict(metric="m.cpu", tags={}, aggregator="p95", rate=True,
         downsample=(600, "avg")),
    dict(metric="m.cpu", tags={"host": "h1|h2|h5"}, aggregator="p999",
         downsample=(600, "avg")),
]


def _spec_id(s):
    return (f"{s['aggregator']}-{'rate' if s.get('rate') else 'plain'}-"
            f"{len(s['tags'])}tags")


def _load(tsdb, series=12, points=200, span=7200, metric="m.cpu"):
    """tests/test_devstore.py's load: random in-span timestamps."""
    rng = np.random.default_rng(7)
    for i in range(series):
        ts = BT + np.sort(rng.choice(span, points, replace=False))
        tsdb.add_batch(metric, ts, rng.normal(100, 10, points),
                       {"host": f"h{i}", "dc": "east" if i % 2 else "west"})


def _port_tsdb(**kw):
    return TSDB(MemKVStore(**kw.pop("store", {})),
                Config(auto_create_metrics=True, device="cpu", **kw),
                start_compaction_thread=False)


def _assert_results(got, want, exact=False):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.tags == b.tags
        assert a.aggregated_tags == b.aggregated_tags
        np.testing.assert_array_equal(a.timestamps, b.timestamps)
        if exact:
            np.testing.assert_array_equal(a.values, b.values)
        else:
            np.testing.assert_allclose(a.values, b.values, rtol=1e-5,
                                       atol=1e-5)


@pytest.fixture(scope="module")
def both_windows():
    """The same add_batch stream into a JAX TSDB and a port TSDB, both
    with the window on and 256-point staging, so chunks cut through
    series and buckets."""
    jt = JaxTSDB(JaxStore(), JaxConfig(auto_create_metrics=True,
                                       enable_sketches=False,
                                       device_window_staging=256),
                 start_compaction_thread=False)
    pt = _port_tsdb(device_window_staging=256)
    _load(jt)
    _load(pt)
    yield jt, pt
    jt.shutdown()
    pt.shutdown()


@pytest.mark.parametrize("fields", MOMENT_SPECS, ids=_spec_id)
def test_window_answers_match_jax_window(both_windows, fields):
    jt, pt = both_windows
    jh, ph = jt.devwindow.window_hits, pt.devwindow.window_hits
    want = JaxExecutor(jt, backend="tpu").run(JaxSpec(**fields), BT,
                                              BT + 7200)
    got, plan, cached = QueryExecutor(pt).run_with_plan(
        QuerySpec(**fields), BT, BT + 7200)
    assert jt.devwindow.window_hits == jh + 1
    assert pt.devwindow.window_hits == ph + 1
    assert plan == "resident" and cached is False
    assert got
    exact = fields["aggregator"] in ("min", "max") and not fields.get(
        "rate")
    _assert_results(got, want, exact=exact)


@pytest.mark.parametrize("fields", PERCENTILE_SPECS, ids=_spec_id)
def test_percentile_group_aggregators_still_answer_400(both_windows,
                                                       fields):
    """Percentile group aggregators are served from the window (the rank
    select over the cached stage's filled grid), as the JAX window serves
    them: same groups, tags and timestamps; values within rtol 1e-5."""
    jt, pt = both_windows
    jh, ph = jt.devwindow.window_hits, pt.devwindow.window_hits
    want = JaxExecutor(jt, backend="tpu").run(JaxSpec(**fields), BT,
                                              BT + 7200)
    got, plan, _ = QueryExecutor(pt).run_with_plan(QuerySpec(**fields), BT,
                                                   BT + 7200)
    assert jt.devwindow.window_hits == jh + 1
    assert pt.devwindow.window_hits == ph + 1
    assert plan == "resident" and got
    _assert_results(got, want)


def test_percentile_downsampler_declined(both_windows):
    """A percentile DOWNSAMPLER (1h-p95) stays on the float64 oracle, as
    in the JAX package: the window declines it."""
    _, pt = both_windows
    hits = pt.devwindow.window_hits
    spec = QuerySpec("m.cpu", {}, "sum", downsample=(600, "p95"))
    got, plan, _ = QueryExecutor(pt).run_with_plan(spec, BT, BT + 7200)
    assert plan == "raw" and got
    assert pt.devwindow.window_hits == hits


# ---------------------------------------------------------------------------
# The port's window against the port's scan path
# ---------------------------------------------------------------------------

@pytest.fixture
def port():
    t = _port_tsdb()
    yield t
    t.shutdown()


def _compare_scan(tsdb, spec, start=BT, end=BT + 7200, expect_hit=True):
    """Window answer vs scan answer on the same TSDB (the window set
    aside, as tests/test_devstore.py does)."""
    ex = QueryExecutor(tsdb)
    h0 = tsdb.devwindow.window_hits
    got, plan, _ = ex.run_with_plan(spec, start, end)
    hit = tsdb.devwindow.window_hits > h0
    assert hit == expect_hit, f"window hit={hit}, wanted {expect_hit}"
    assert plan == ("resident" if expect_hit else "raw")
    dw, tsdb.devwindow = tsdb.devwindow, None
    try:
        want, plan, _ = ex.run_with_plan(spec, start, end)
    finally:
        tsdb.devwindow = dw
    assert plan == "raw"
    _assert_results(got, want)
    return got


@pytest.mark.parametrize("fields", MOMENT_SPECS + PERCENTILE_SPECS,
                         ids=_spec_id)
def test_equals_scan_path(port, fields):
    _load(port)
    _compare_scan(port, QuerySpec(**fields))


def test_partial_range(port):
    """A sub-range query: range masking on the device matches the scan
    path's [start, end] span trim."""
    _load(port)
    _compare_scan(port, QuerySpec("m.cpu", {}, "sum",
                                  downsample=(300, "avg")),
                  start=BT + 1800, end=BT + 5400)


def test_series_outside_range_do_not_shape_labels(port):
    """A series with no points in the queried range must not appear in
    group labels (scan-path semantics: it is never seen)."""
    _load(port, series=3, span=3600)
    port.add_batch("m.cpu", BT + 7200 + np.arange(10) * 60,
                   np.arange(10.0), {"host": "h9", "dc": "west"})
    for tags in ({}, {"host": "*"}):
        _compare_scan(port, QuerySpec("m.cpu", tags, "sum",
                                      downsample=(600, "avg")),
                      start=BT, end=BT + 3600)


def test_no_matching_series_empty(port):
    _load(port, series=2)
    port.add_batch("m.other", BT + np.arange(5) * 60, np.arange(5.0),
                   {"host": "h9", "dc": "east"})
    h0 = port.devwindow.window_hits
    out = QueryExecutor(port).run(QuerySpec("m.cpu", {"host": "h9"}, "sum",
                                            downsample=(600, "avg")),
                                  BT, BT + 7200)
    assert out == []
    assert port.devwindow.window_hits > h0


def test_stage_cache_reused_and_dead_versions_dropped(port):
    """Panels over the same (range, interval, downsample) share one
    cached stage whatever their filter; new data bumps the version, and
    the dead version's stage leaves the cache."""
    _load(port, series=4)
    ex = QueryExecutor(port)
    for tags in ({}, {"host": "*"}, {"dc": "east"}):
        ex.run(QuerySpec("m.cpu", tags, "sum", downsample=(600, "avg")),
               BT, BT + 7200)
    keys = ex._dw_stage_cache.keys()
    assert len(keys) == 1
    port.add_batch("m.cpu", BT + 7300 + np.arange(3), np.ones(3),
                   {"host": "h0", "dc": "west"})
    ex.run(QuerySpec("m.cpu", {}, "sum", downsample=(600, "avg")),
           BT, BT + 7200)
    new = ex._dw_stage_cache.keys()
    assert len(new) == 1 and new != keys
