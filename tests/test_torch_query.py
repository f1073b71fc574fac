"""The port's scan path as a whole: the same put stream into the JAX
package (TSDB + QueryExecutor on JAX's CPU backend) and into the port
(TSDB + executor on device="cpu"), both with the resident window off, the
same /q expressions through both. (The window path: test_torch_window.py.)

Contract (opentsdb_tpu/query/executor.py:16-18): identical groups, tags
and timestamps; count, min and max values exact; float32 sums, means and
deviations within rtol 1e-5, since the segment sums add in another order.
"""

import numpy as np
import pytest

from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu.query.grammar import parse_m
from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config

BT = 1356998400  # hour-aligned epoch
START, END = BT, BT + 6 * 3600

QUERIES = [
    "sum:1h-avg:sys.cpu.user",
    "max:1m-max:sys.cpu.user{host=*}",
    "dev:1h-avg:sys.cpu.user{dc=*}",
    "sum:rate{counter,,}:1h-avg:net.bytes",
]


def _stream(seed=5):
    """(metric, tags, timestamps, values, as_points) series: a 2-dc x
    3-host float metric over 6 hours and an integer byte counter; a few
    series go through add_point, so their rows compact."""
    rng = np.random.default_rng(seed)
    out = []
    for dc in ("east", "west"):
        for h in range(3):
            tags = {"host": f"{dc}{h}", "dc": dc}
            n = int(rng.integers(200, 400))
            ts = np.sort(rng.choice(6 * 3600, n, replace=False)) + BT
            out.append(("sys.cpu.user", tags, ts,
                        rng.normal(50, 10, n), h == 0))
            n = int(rng.integers(50, 100))
            ts = np.sort(rng.choice(6 * 3600, n, replace=False)) + BT
            out.append(("net.bytes", tags, ts,
                        np.cumsum(rng.integers(0, 1000, n)), False))
    return out


def _feed(tsdb, stream):
    for metric, tags, ts, vals, as_points in stream:
        if as_points:
            for t, v in zip(ts.tolist(), vals.tolist()):
                tsdb.add_point(metric, t, v, tags)
        else:
            tsdb.add_batch(metric, ts, vals, tags)


def _jax_tsdb(wal=None):
    return JaxTSDB(JaxStore(wal_path=wal),
                   JaxConfig(device_window=False, enable_sketches=False,
                             auto_create_metrics=True),
                   start_compaction_thread=False)


def _port_tsdb(wal=None):
    return TSDB(MemKVStore(wal_path=wal),
                Config(auto_create_metrics=True, device="cpu",
                       device_window=False),
                start_compaction_thread=False)


def _specs(expr):
    p = parse_m(expr)
    fields = dict(metric=p.metric, tags=p.tags, aggregator=p.aggregator,
                  rate=p.rate, downsample=p.downsample, counter=p.counter,
                  counter_max=p.counter_max, reset_value=p.reset_value)
    return JaxSpec(**fields), QuerySpec(**fields)


def _assert_same(want, got, expr):
    assert len(got) == len(want), expr
    p = parse_m(expr)
    # Union-grid lerps may round apart from XLA's (min and max of them
    # too); counts stay exact.
    exact = p.aggregator in ("min", "max", "count") and not p.rate \
        and (p.downsample is not None or p.aggregator == "count")
    for w, g in zip(want, got):
        assert g.metric == w.metric and g.tags == w.tags
        assert g.aggregated_tags == w.aggregated_tags
        np.testing.assert_array_equal(g.timestamps, w.timestamps)
        assert g.values.dtype == w.values.dtype == np.float64
        if exact:
            np.testing.assert_array_equal(g.values, w.values)
        else:
            np.testing.assert_allclose(g.values, w.values, rtol=1e-5,
                                       atol=1e-6)


@pytest.fixture(scope="module")
def both():
    stream = _stream()
    jt, pt = _jax_tsdb(), _port_tsdb()
    _feed(jt, stream)
    _feed(pt, stream)
    # Compact the add_point rows on both sides: queries then read the
    # merged cells the background queue would have written.
    jt.compactionq.flush()
    pt.compactionq.flush()
    yield jt, pt
    jt.shutdown()
    pt.shutdown()


@pytest.mark.parametrize("expr", QUERIES)
def test_queries_match_jax(both, expr):
    jt, pt = both
    jspec, pspec = _specs(expr)
    want = JaxExecutor(jt, backend="tpu").run(jspec, START, END)
    got, plan, cached = QueryExecutor(pt).run_with_plan(pspec, START, END)
    assert plan == "raw" and cached is False
    assert got, expr
    _assert_same(want, got, expr)


@pytest.mark.parametrize("expr", QUERIES + ["sum:1h-p95:sys.cpu.user"])
def test_oracle_backend_matches_jax_oracle(both, expr):
    """backend="cpu" keeps its JAX-package meaning: the float64 oracle."""
    jt, pt = both
    jspec, pspec = _specs(expr)
    want = JaxExecutor(jt, backend="cpu").run(jspec, START, END)
    got = QueryExecutor(pt, backend="cpu").run(pspec, START, END)
    _assert_same(want, got, expr)


def test_stored_rows_byte_identical(both):
    jt, pt = both
    for table in ("tsdb", "tsdb-uid"):
        want = list(jt.store.scan_raw(table, b"", b"\xff" * 64))
        got = list(pt.store.scan_raw(table, b"", b"\xff" * 64))
        assert got == want


# Un-downsampled queries (the union grid, rates per point first) and
# percentile group aggregators (the rank select), held against the JAX
# package on the same stream. Lerped quantiles and union-grid sums are
# float32 arithmetic in another order: rtol 1e-5, as the moments.
UNPORTED = [
    "avg:sys.cpu.user{dc=*}", "dev:sys.cpu.user",
    "zimsum:sys.cpu.user", "mimmin:sys.cpu.user{dc=*}",
    "mimmax:sys.cpu.user", "min:sys.cpu.user", "max:sys.cpu.user{host=*}",
    "count:sys.cpu.user", "sum:rate:sys.cpu.user",
    "sum:rate{counter,,}:net.bytes{host=*}", "p95:sys.cpu.user",
    "p50:rate:sys.cpu.user{dc=*}", "p99:1h-avg:sys.cpu.user",
    "p95:10m-avg:sys.cpu.user{host=*}", "p50:rate:10m-avg:sys.cpu.user{dc=*}",
    "p999:1m-max:sys.cpu.user{dc=*}",
]


@pytest.mark.parametrize("expr,what", [
    ("p95:1h-avg:sys.cpu.user", "percentile group aggregator"),
    ("sum:sys.cpu.user", "without a downsampler"),
])
def test_unported_queries_answer_400(both, expr, what):
    """The two query kinds the port once refused (a {what}) now answer
    the JAX package's answer on the scan path."""
    jt, pt = both
    jspec, pspec = _specs(expr)
    want = JaxExecutor(jt, backend="tpu").run(jspec, START, END)
    got, plan, _ = QueryExecutor(pt).run_with_plan(pspec, START, END)
    assert plan == "raw" and got, what
    _assert_same(want, got, expr)


@pytest.mark.parametrize("expr", UNPORTED)
def test_percentile_and_undownsampled_match_jax(both, expr):
    jt, pt = both
    jspec, pspec = _specs(expr)
    want = JaxExecutor(jt, backend="tpu").run(jspec, START, END)
    got, plan, _ = QueryExecutor(pt).run_with_plan(pspec, START, END)
    assert plan == "raw" and got, expr
    _assert_same(want, got, expr)


@pytest.mark.parametrize("expr", ["sum:sys.cpu.user{host=*}",
                                  "p95:sys.cpu.user", "dev:sys.cpu.user"])
def test_undownsampled_matches_oracle(both, expr):
    """The float64 oracle as the tiebreak: the union-grid answers equal
    the port's own oracle backend to float32 tolerance."""
    _, pt = both
    _, pspec = _specs(expr)
    got = QueryExecutor(pt).run(pspec, START, END)
    want = QueryExecutor(pt, backend="cpu").run(pspec, START, END)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.timestamps, w.timestamps)
        np.testing.assert_allclose(g.values, w.values, rtol=1e-4,
                                   atol=1e-4)


def test_port_opens_jax_wal(tmp_path):
    """The data is the state carried across: a WAL the JAX package wrote
    (batch records, single puts, UID allocations, compaction rewrites and
    deletes) replays into the port, which then answers like the JAX
    TSDB did."""
    wal = str(tmp_path / "wal")
    stream = _stream(seed=9)
    jt = _jax_tsdb(wal)
    _feed(jt, stream)
    jt.compactionq.flush()
    want = {e: JaxExecutor(jt, backend="tpu").run(_specs(e)[0], START, END)
            for e in QUERIES}
    jt.shutdown()

    pt = _port_tsdb(wal)
    try:
        for expr in QUERIES:
            _assert_same(want[expr],
                         QueryExecutor(pt).run(_specs(expr)[1], START, END),
                         expr)
        # ... and keeps appending in the same format (a new tag value
        # allocates a UID too): the JAX store replays it on top.
        pt.add_batch("sys.cpu.user", np.array([END - 5]), np.array([1.5]),
                     {"host": "new0", "dc": "east"})
    finally:
        pt.shutdown()
    jt = _jax_tsdb(wal)
    try:
        spec = _specs("max:1m-max:sys.cpu.user{host=new0}")[0]
        (r,) = JaxExecutor(jt, backend="cpu").run(spec, END - 60, END)
        np.testing.assert_array_equal(r.timestamps, [END - 60])
        np.testing.assert_array_equal(r.values, [1.5])
    finally:
        jt.shutdown()


def test_port_refuses_spilled_jax_store(tmp_path):
    """A store the JAX package spilled to compressed TSST4 blocks, which
    the port refused before it read them (ROADMAP item 5), now opens in
    the port with every row the JAX store holds: no part of it refused
    or lost (tests/test_torch_compress.py holds the rest of the format)."""
    wal = str(tmp_path / "wal")
    jt = _jax_tsdb(wal)
    jt.store.sstable_codec = "tsst4"
    _feed(jt, _stream()[:2])
    jt.checkpoint()
    jt.shutdown()
    got = {}
    for name, cls in (("jax", JaxStore), ("port", MemKVStore)):
        store = cls(wal_path=wal)
        try:
            assert [g.format for g in store._ssts] == [4]
            got[name] = {tb: list(store.scan_raw(tb, b"", b""))
                         for tb in ("tsdb", "tsdb-uid")}
        finally:
            store.close()
    assert got["port"] == got["jax"]
    assert got["port"]["tsdb"]
