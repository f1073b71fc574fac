"""Tenant accounting, limits, ingest admission and HTTP ingest of the port
(``opentsdb_tpu_torch/tenant/``, ``serve/admission.py``, ``/api/put``,
``/api/tenants``) against the JAX package, on the CPU (``device="cpu"``).

The same inputs, made with numpy from a seed, go through both packages.
Every comparison here is exact: accountant counts, tiers, HLL registers
and heavy hitters equal; snapshot files byte-identical, each package
loading the other's; the same refusals, UID tables and stored rows; the
telnet refusal line, the 429 body and the ``/api/tenants`` JSON
byte-identical to the JAX daemon's; ``/api/put`` bodies (JSON and put
lines) storing the same bytes as telnet ``put``.
"""

import asyncio
import json
import os
import threading
import time

import numpy as np
import pytest

from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.serve import admission as jadm
from opentsdb_tpu.server import wire as jwire
from opentsdb_tpu.server.tsd import TSDServer as JaxServer
from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
from opentsdb_tpu.tenant import accounting as jacc
from opentsdb_tpu.tenant import limits as jlim
from opentsdb_tpu.tools import cli as jcli
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.serve import admission as padm
from opentsdb_tpu_torch.server import wire as pwire
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.tenant import accounting as pacc
from opentsdb_tpu_torch.tenant import limits as plim
from opentsdb_tpu_torch.tools import cli as pcli
from opentsdb_tpu_torch.utils.config import Config

BT = 1356998400
BOTH = [(jacc, jlim), (pacc, plim)]


# ---------------------------------------------------------------------------
# Accountant
# ---------------------------------------------------------------------------

def _items(ss):
    return list(ss.items.items()), ss.total


def test_space_saving_tops_and_errors_equal():
    rng = np.random.default_rng(1)
    keys = rng.zipf(1.3, 4000) % 60
    weights = rng.integers(1, 20, 4000)
    out = []
    for acc, _ in BOTH:
        ss = acc.SpaceSaving(8)
        for k, w in zip(keys.tolist(), weights.tolist()):
            ss.offer(f"k{k}", w)
        ss.offer("zero", 0)
        back = acc.SpaceSaving.from_json(8, json.loads(json.dumps(
            ss.to_json())))
        out.append((_items(ss), ss.top(5), _items(back)))
    assert out[0] == out[1]
    assert len(out[0][0][0]) == 8


@pytest.mark.parametrize("metric", ["sys.cpu.user", "sys", "a.b", "",
                                    "x.y.z.w"])
def test_metric_prefix_equal(metric):
    assert pacc.metric_prefix(metric) == jacc.metric_prefix(metric)


@pytest.mark.parametrize("p", [4, 10, 12, 14])
def test_hll_helpers_equal(p):
    rng = np.random.default_rng(p)
    h = rng.integers(0, 1 << 32, 5000, dtype=np.uint64)
    h[:3] = [0, 1, (1 << 32) - 1]
    np.testing.assert_array_equal(pacc._mix64(h), jacc._mix64(h))
    regs = []
    for acc, _ in BOTH:
        r = np.zeros(1 << p, np.uint8)
        acc._hll_fold(r, h[:2000], p)
        acc._hll_fold(r, h[2000:], p)
        acc._hll_fold(r, h[:0], p)
        regs.append(r)
    np.testing.assert_array_equal(regs[0], regs[1])
    assert pacc._hll_estimate(regs[1]) == jacc._hll_estimate(regs[0])
    assert pacc.hll_rel_error(p) == jacc.hll_rel_error(p)


def _feed(acc, seed=0, n=2000, cutoff=500, p=10):
    """One seeded stream of accountant calls: three tenants, one of them
    past the exact cutoff, heavy hitters, refusals, a recovered fold."""
    rng = np.random.default_rng(seed)
    a = acc.TenantAccountant(exact_cutoff=cutoff, hll_p=p, topk=4)
    hashes = rng.integers(0, 1 << 32, n, dtype=np.uint64).tolist()
    for i, h in enumerate(hashes):
        t = "big" if i % 3 else ("t0", "t1")[i % 2]
        metric = f"ns{rng.integers(0, 6)}.svc{rng.integers(0, 3)}.m"
        a.note_new_series(t, int(h), metric)
        a.note_new_series(t, int(h), metric)       # a repeat is no-op
        if i % 7 == 0:
            a.note_points(t, f"{metric}{{id={i % 50}}}",
                          int(rng.integers(1, 100)))
        if i % 97 == 0:
            a.record_refusal(t, bool(i % 2))
    a.fold_recovered(rng.integers(0, 1 << 32, 50).tolist() + hashes[:10])
    return a


def _state(a):
    return {name: (st.tier(), st.count(),
                   sorted(st.exact) if st.exact is not None
                   else st.hll.tobytes(),
                   st.points, st.refused, st.would_refuse,
                   _items(st.hh_series), _items(st.hh_prefixes))
            for name, st in a._tenants.items()}


def test_accountant_tiers_counts_and_heavy_hitters_equal():
    j, p = _feed(jacc), _feed(pacc)
    assert list(p._tenants) == list(j._tenants)
    assert _state(p) == _state(j)
    assert p.snapshot_info() == j.snapshot_info()
    assert p._seen == j._seen
    info = p.snapshot_info()
    assert info["tenants"]["big"]["tier"] == "hll"
    assert info["tenants"]["t0"]["tier"] == "exact"
    assert info["recovered_series"] == 50
    for h in list(p._seen)[:20] + [5, 6]:
        assert p.seen(h) == j.seen(h)
    assert p.count("big") == j.count("big") and p.count("none") == 0
    assert p.total_tracked() == j.total_tracked()


def test_hll_promotion_accuracy_equal():
    rng = np.random.default_rng(7)
    hashes = rng.choice(1 << 32, size=20_000, replace=False)
    counts = []
    for acc, _ in BOTH:
        a = acc.TenantAccountant(exact_cutoff=64, hll_p=12)
        for h in hashes.tolist():
            a.note_new_series("big", int(h), "m.x")
        counts.append((a.count("big"), a._tenants["big"].hll.tobytes()))
    assert counts[0] == counts[1]
    assert abs(counts[1][0] - 20_000) <= 3 * pacc.hll_rel_error(12) * 20_000


# ---------------------------------------------------------------------------
# Snapshot bytes
# ---------------------------------------------------------------------------

def test_snapshot_bytes_identical_and_cross_both_ways(tmp_path):
    paths = {}
    infos = {}
    for name, (acc, _) in zip(("jax", "port"), BOTH):
        a = _feed(acc)
        paths[name] = str(tmp_path / f"{name}.tenants.json")
        a.save(paths[name])
        infos[name] = a.snapshot_info()
    body = open(paths["port"], "rb").read()
    assert body == open(paths["jax"], "rb").read()
    assert pacc.TenantAccountant(path=None).save() == 0
    # Each package loads the other's file into the same state, and saves
    # it back byte for byte.
    for loader, src in ((jacc, "port"), (pacc, "jax")):
        back = loader.TenantAccountant.load(paths[src])
        info = back.snapshot_info()
        assert info.pop("snapshots_written") == 0
        want = dict(infos[src])
        assert want.pop("snapshots_written") == 1
        assert info == want
        out = str(tmp_path / f"{src}.again")
        back.save(out)
        assert open(out, "rb").read() == body


def test_torn_and_foreign_snapshots_raise_in_both(tmp_path):
    path = str(tmp_path / "t.json")
    a = pacc.TenantAccountant(path=path, exact_cutoff=1)
    for h in range(3):
        a.note_new_series("t", h, "m.x")
    a.save()
    body = open(path, "rb").read()
    # Torn, foreign versions (the port's old marker among them), and an
    # HLL bank whose size disagrees with the file's p.
    cases = [body[:len(body) // 2], b'{"version": 99}',
             b'{"version": 0, "written_by": "opentsdb_tpu_torch"}',
             json.dumps({**json.loads(body), "hll_p": 9}).encode()]
    for raw in cases:
        with open(path, "wb") as f:
            f.write(raw)
        errs = []
        for acc, _ in BOTH:
            with pytest.raises(Exception) as ei:
                acc.TenantAccountant.load(path)
            errs.append((type(ei.value), str(ei.value)))
        assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# Limiter
# ---------------------------------------------------------------------------

def _limiter_run(acc, lim, **kw):
    """Admit seeded new series for several tenants; every outcome."""
    rng = np.random.default_rng(3)
    a = acc.TenantAccountant()
    L = lim.TenantLimiter(**kw)
    out = [L.enabled, L.limit_for("vip"), L.limit_for("other")]
    for i in range(60):
        t = ("t", "vip", "tiny", "u")[int(rng.integers(0, 4))]
        try:
            L.admit_new_series(a, t)
            a.note_new_series(t, i, "m.x")
            out.append(("ok", t))
        except Exception as e:
            out.append((type(e).__name__, str(e), e.status, e.tenant,
                        e.limit, e.count, e.scope,
                        isinstance(e, OSError)))
    return out, a.snapshot_info(L)


@pytest.mark.parametrize("kw", [
    dict(max_series=5),
    dict(max_series=1, overrides={"vip": 0, "tiny": 3}),
    dict(global_max=9),
    dict(max_series=4, global_max=11, overrides={"vip": 20}),
    dict(max_series=2, mode="warn"),
    dict(max_series=2, global_max=5, mode="warn"),
    dict(),
])
def test_limiter_outcomes_equal(kw):
    j = _limiter_run(jacc, jlim, **kw)
    p = _limiter_run(pacc, plim, **kw)
    assert p == j
    kinds = {o[0] for o in p[0][3:]}
    assert kinds == ({"ok", "TenantLimitError"}
                     if kw and kw.get("mode") != "warn" else {"ok"})


def test_parse_overrides_equal():
    assert plim.parse_overrides(("a=5", "b=0", "x=y=2")) \
        == jlim.parse_overrides(("a=5", "b=0", "x=y=2")) \
        == {"a": 5, "b": 0, "x=y": 2}
    for bad in (("nolimit",), ("=3",)):
        for mod in (jlim, plim):
            with pytest.raises(ValueError, match="bad tenant override"):
                mod.parse_overrides(bad)


def test_bad_mode_rejected():
    msgs = []
    for mod in (jlim, plim):
        with pytest.raises(ValueError) as ei:
            mod.TenantLimiter(mode="audit")
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# Admission
# ---------------------------------------------------------------------------

def test_token_bucket_under_injected_clock_equal():
    rng = np.random.default_rng(5)
    steps = [(float(rng.integers(1, 30)), float(rng.uniform(0, 0.5)))
             for _ in range(200)]
    out = []
    for adm in (jadm, padm):
        b = adm.TokenBucket(40.0, 25.0)
        # One injected clock for both buckets: each constructor stamps
        # its own time.monotonic(), and `now += dt` rounds differently
        # on two bases.
        b._t = b.last_take = now = 1000.0
        got = []
        for n, dt in steps:
            now += dt
            got.append(b.take(n, now=now))
        got.append(b.take(1.0, now=now - 10.0))   # time never flows back
        out.append((got, b.last_take))
    assert out[0] == out[1]
    assert any(w > 0 for w in out[1][0]) and any(w == 0 for w in out[1][0])
    for adm in (jadm, padm):
        with pytest.raises(ValueError, match="rate must be > 0"):
            adm.TokenBucket(0, 1)


def _admission(adm, cfg_cls, **kw):
    return adm.AdmissionController(cfg_cls(**kw))


def test_ingest_admission_equal():
    out = []
    for adm, cfg in ((jadm, JaxConfig), (padm, Config)):
        a = _admission(adm, cfg, ingest_queue_points=100)
        seq = [a.admit_ingest(60, "t"), a.admit_ingest(50, "t")]
        a.ingest_done(60)
        seq += [a.admit_ingest(50, "u"), a.inflight_ingest_points]
        b = _admission(adm, cfg, ingest_rate=100.0, ingest_burst_s=1.0)
        seq += [b.admit_ingest(80, "t") == 0.0, b.admit_ingest(80, "t") > 0,
                b.admit_ingest(80, "u") == 0.0, b.ingest_shed_quota,
                sorted(b._ingest_buckets)]
        c = _admission(adm, cfg, ingest_rate=1000.0,
                       ingest_queue_points=10)
        seq += [c.admit_ingest(20, "t"), c.inflight_ingest_points,
                c.ingest_shed_queue, c.admit_ingest(5, "t"),
                c.inflight_ingest_points]
        off = _admission(adm, cfg)
        seq += [off.admit_ingest(10 ** 9), off.inflight_ingest_points]
        out.append(seq)
    assert out[0] == out[1]
    assert out[1][:4] == [0.0, 0.5, 0.0, 50]


@pytest.mark.parametrize("case", ["evict", "collapse"])
def test_bucket_eviction_and_collapse_equal(monkeypatch, case):
    """The JAX package's TestBucketEviction cases through both
    controllers: the least recently used idle bucket goes (and its
    successor starts cold), or, with every slot active, the newcomer
    collapses onto the shared "default" bucket."""
    out = []
    for adm, cfg in ((jadm, JaxConfig), (padm, Config)):
        monkeypatch.setattr(adm.AdmissionController, "MAX_TENANTS",
                            3 if case == "evict" else 2)
        a = _admission(adm, cfg, query_rate=10.0, query_burst=4.0)
        seq = []
        if case == "evict":
            for t in ("alive", "idle1", "idle2"):
                seq.append(a.admit_query(t)[0])
                a.query_done()
            now = time.monotonic()
            a._query_buckets["idle1"].last_take = now - 120.0
            a._query_buckets["idle2"].last_take = now - 600.0
            a._query_buckets["alive"].last_take = now
            verdict, retry = a.admit_query("fresh")
            seq += [verdict, retry > 0]
        else:
            for t in ("a", "b", "spray", "spray2"):
                seq.append(a.admit_query(t)[0])
                a.query_done()
        seq += [sorted(a._query_buckets), a.tenants_evicted,
                a.tenants_collapsed, a.inflight_queries]
        out.append(seq)
    assert out[0] == out[1]
    if case == "evict":
        assert out[1][3:5] == [padm.SHED_QUOTA, True]
        assert out[1][5] == ["alive", "fresh", "idle1"]
    else:
        assert "spray" not in out[1][4] and out[1][6] == 2


def test_query_ladder_equal():
    out = []
    for adm, cfg in ((jadm, JaxConfig), (padm, Config)):
        a = _admission(adm, cfg, query_max_inflight=2)
        out.append([a.admit_query("t") for _ in range(5)]
                   + [a.query_shed_load, a.query_degraded])
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# The same ingest through both TSDBs
# ---------------------------------------------------------------------------

def _jax_tsdb(wal, **kw):
    cfg = dict(auto_create_metrics=True, enable_compactions=False,
               enable_sketches=False, device_window=False, backend="cpu")
    cfg.update(kw)
    return JaxTSDB(JaxStore(wal_path=wal), JaxConfig(**cfg),
                   start_compaction_thread=False)


def _port_tsdb(wal, **kw):
    cfg = dict(auto_create_metrics=True, enable_compactions=False,
               enable_sketches=False, device_window=False, device="cpu")
    cfg.update(kw)
    return TSDB(MemKVStore(wal_path=wal), Config(**cfg),
                start_compaction_thread=False)


def _ops(seed=0, n=120):
    """Seeded puts: (single?, tenant, metric, tags, timestamps, values)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        tenant = ("t", "u", "vip", "tiny")[int(rng.integers(0, 4))]
        metric = ("m.a", "m.b", f"m.new{int(rng.integers(0, 4))}")[
            int(rng.integers(0, 3))]
        tags = {"id": str(int(rng.integers(0, 6)))}
        if rng.random() < 0.3:
            tags[f"k{int(rng.integers(0, 3))}"] = f"v{int(rng.integers(0, 3))}"
        k = int(rng.integers(1, 5))
        ts = BT + i * 60 + np.arange(k, dtype=np.int64)
        vals = rng.normal(0, 10, k).round(2)
        ops.append((bool(rng.random() < 0.4), tenant, metric, tags, ts,
                    vals))
    return ops


def _drive(tsdb, ops):
    out = []
    for single, tenant, metric, tags, ts, vals in ops:
        try:
            if single:
                tsdb.add_point(metric, int(ts[0]), float(vals[0]), tags,
                               tenant=tenant)
                out.append(("ok", 1))
            else:
                out.append(("ok", tsdb.add_batch(metric, ts, vals, tags,
                                                 tenant=tenant)))
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    return out


def _dump(tsdb):
    return {tb: list(tsdb.store.scan_raw(tb, b"", b""))
            for tb in ("tsdb", "tsdb-uid")}


def _info(tsdb):
    return tsdb.tenants.snapshot_info(tsdb.tenant_limits)


LIMITS = [
    dict(tenant_max_series=4, tenant_overrides=("vip=0", "tiny=2")),
    dict(tenant_global_max_series=9),
    dict(tenant_max_series=3, tenant_limit_mode="warn"),
    dict(tenant_max_series=5, tenant_exact_cutoff=3),
]


@pytest.mark.parametrize("kw", LIMITS)
def test_same_ingest_same_refusals_uids_and_rows(tmp_path, kw):
    ops = _ops()
    j = _jax_tsdb(str(tmp_path / "j"), **kw)
    p = _port_tsdb(str(tmp_path / "p"), **kw)
    try:
        got, want = _drive(p, ops), _drive(j, ops)
        assert got == want
        assert _dump(p) == _dump(j)
        assert _info(p) == _info(j)
        refused = sum(o[0] == "TenantLimitError" for o in got)
        assert refused > 0 or kw.get("tenant_limit_mode") == "warn"
        assert sum(o[0] == "ok" for o in got) > 20
    finally:
        j.shutdown()
        p.shutdown()
    # The checkpointed snapshots are the same bytes.
    assert open(str(tmp_path / "p.tenants.json"), "rb").read() \
        == open(str(tmp_path / "j.tenants.json"), "rb").read()


def test_refused_series_allocates_no_uids(tmp_path):
    out = []
    for make, name in ((_jax_tsdb, "j"), (_port_tsdb, "p")):
        t = make(str(tmp_path / name), tenant_max_series=1)
        ts, val = np.asarray([BT], np.int64), np.asarray([1.0])
        seq = _drive(t, [(False, "t", "m.a", {"id": "0"}, ts, val),
                         (True, "t", "m.leak", {"leakk": "leakv"}, ts, val),
                         (False, "t", "m.leak2", {"id": "xx"}, ts, val)])
        for uid_map, uid_name in ((t.metrics, "m.leak"),
                                  (t.metrics, "m.leak2"),
                                  (t.tagk, "leakk"), (t.tagv, "leakv"),
                                  (t.tagv, "xx")):
            with pytest.raises(Exception, match="No such name"):
                uid_map.get_id(uid_name)
        out.append((seq, _dump(t), _info(t)))
        t.shutdown()
    assert out[0] == out[1]
    assert [o[0] for o in out[1][0]] == ["ok", "TenantLimitError",
                                         "TenantLimitError"]


def test_unknown_metric_not_masked_as_refusal(tmp_path):
    out = []
    for make, name in ((_jax_tsdb, "j"), (_port_tsdb, "p")):
        t = make(str(tmp_path / name), tenant_max_series=1,
                 auto_create_metrics=False)
        t.metrics.get_or_create_id("m.a")
        ts, val = np.asarray([BT], np.int64), np.asarray([1.0])
        seq = _drive(t, [(True, "t", "m.a", {"id": "0"}, ts, val),
                         (True, "t", "m.nope", {"id": "0"}, ts, val),
                         (False, "t", "m.nope", {"id": "1"}, ts, val),
                         (True, "t", "m.a", {"id": "fresh"}, ts, val)])
        out.append((seq, _info(t)))
        t.shutdown()
    assert out[0] == out[1]
    assert [o[0] for o in out[1][0]] == [
        "ok", "NoSuchUniqueName", "NoSuchUniqueName", "TenantLimitError"]
    assert out[1][1]["tenants"]["t"]["refused"] == 1


def _reopen_info(make, wal, **kw):
    t = make(wal, **kw)
    try:
        return (_info(t), t.tenants.rebuilt, t.tenants.recovered_series,
                sorted(t.tenants._seen))
    finally:
        t.shutdown()


def _seed_store(make, wal, n=6, **kw):
    t = make(wal, **kw)
    ts, val = np.asarray([BT], np.int64), np.asarray([1.0])
    for i in range(n):
        t.add_batch("m.a", ts, val, {"id": str(i)},
                    tenant=("a", "b")[i % 2])
    return t


@pytest.mark.parametrize("limits", [True, False])
def test_missing_snapshot_rebuild_gated_on_limits(tmp_path, limits):
    """No snapshot: with limits the open rebuilds from all of storage
    (enforcement must know every stored series); without, it folds only
    the memtable, which a checkpoint has emptied. Both packages alike."""
    kw = dict(tenant_max_series=5) if limits else {}
    out = []
    for make, name in ((_jax_tsdb, "j"), (_port_tsdb, "p")):
        wal = str(tmp_path / name)
        t = _seed_store(make, wal, n=3, **kw)
        t.checkpoint()
        ts, val = np.asarray([BT + 60], np.int64), np.asarray([1.0])
        t.add_batch("m.a", ts, val, {"id": "late"}, tenant="a")
        os.remove(t.tenants.path)
        t.store.close()        # a crash: no shutdown checkpoint
        out.append(_reopen_info(make, wal, **kw))
    assert out[0] == out[1]
    info, rebuilt, recovered, seen = out[1]
    assert rebuilt is False
    assert info["tracked_series"] == (4 if limits else 1)
    assert recovered == info["tracked_series"]


def test_checkpoint_reopen_and_crossing(tmp_path):
    """Checkpoint and reopen in each package, then each package reopens
    the other's directory: the loaded state is the same, no rebuild, and
    WAL-replayed series fold onto the default tenant."""
    out = {}
    for make, name in ((_jax_tsdb, "j"), (_port_tsdb, "p")):
        wal = str(tmp_path / name)
        t = _seed_store(make, wal, tenant_exact_cutoff=2)
        t.checkpoint()
        ts, val = np.asarray([BT + 60], np.int64), np.asarray([1.0])
        t.add_batch("m.b", ts, val, {"id": "0"}, tenant="a")
        t.store.close()        # the m.b series lives only in the WAL
        out[name] = wal
    infos = [_reopen_info(make, out[src]) for make, src in
             ((_jax_tsdb, "j"), (_port_tsdb, "p"), (_jax_tsdb, "p"),
              (_port_tsdb, "j"))]
    assert infos[0] == infos[1]
    # Each reopen's shutdown checkpointed (snapshots_written 1 in the
    # second pair's state, but not in what it reports at open).
    infos2 = [_reopen_info(make, out[src]) for make, src in
              ((_jax_tsdb, "p"), (_port_tsdb, "j"))]
    assert infos2[0] == infos2[1]
    info, rebuilt, recovered, _ = infos[1]
    assert not rebuilt and recovered == 1
    assert info["tenants"]["a"]["tier"] == "hll"
    assert info["tenants"]["default"]["series"] == 1
    assert info["tracked_series"] == 7


def _torn(path):
    body = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(body[:len(body) // 2])


def _foreign(path):
    with open(path, "w") as f:
        json.dump({"version": 99}, f)


@pytest.mark.parametrize("damage", ["torn", "foreign", "marker"])
def test_torn_foreign_and_marker_rebuild(tmp_path, damage):
    """A torn or foreign snapshot rebuilds from all of storage in both
    packages: totals exact, every series on the default tenant, declared
    as recovered. ``marker``: the store was written by a writer without
    accounting (the version-0 file each checkpoint of the port left
    before accounting was ported). After one checkpoint of the port, the
    JAX package loads the port's snapshot without a rescan."""
    out = []
    for make, name in ((_jax_tsdb, "j"), (_port_tsdb, "p")):
        wal = str(tmp_path / name)
        if damage == "marker":
            t = _seed_store(_port_tsdb, wal, n=9, tenant_accounting=False)
            assert t.tenants is None
            t.shutdown()
            assert json.load(open(wal + ".tenants.json"))["version"] == 0
        else:
            t = _seed_store(make, wal, n=9)
            t.shutdown()
            (_torn if damage == "torn" else _foreign)(wal + ".tenants.json")
        out.append(_reopen_info(make, wal))
    assert out[0] == out[1]
    info, rebuilt, recovered, _ = out[1]
    assert rebuilt and recovered == 9
    assert info["tenants"]["default"]["series"] == 9
    assert info["total_series"] == info["tracked_series"] == 9
    # The port's reopen above checkpointed a real snapshot: the JAX
    # package loads it as is.
    again = _reopen_info(_jax_tsdb, str(tmp_path / "p"))
    assert again[1] is False and again[0]["tracked_series"] == 9
    assert again[0] == out[1][0]


def test_accounting_off_writes_the_marker_and_read_only_has_none(tmp_path):
    wal = str(tmp_path / "p")
    t = _port_tsdb(wal, tenant_accounting=False)
    t.add_point("m.a", BT, 1.0, {"id": "0"}, tenant="t")
    assert t.tenants is None and t.tenant_limits is None
    t.shutdown()
    assert json.load(open(wal + ".tenants.json"))["version"] == 0
    store = MemKVStore()
    store.read_only = True
    r = TSDB(store, Config(device="cpu", device_window=False),
             start_compaction_thread=False)
    assert r.tenants is None and r.tenant_limits is None
    assert TSDB(MemKVStore(), Config(device="cpu", device_window=False),
                start_compaction_thread=False).tenants is not None


# ---------------------------------------------------------------------------
# Wire: decode_json_puts
# ---------------------------------------------------------------------------

def _json_body(seed):
    rng = np.random.default_rng(seed)
    obj = []
    for i in range(300):
        r = rng.random()
        d = {"metric": f"j.m{int(rng.integers(0, 3))}",
             "timestamp": BT + i,
             "value": int(rng.integers(-5, 5)),
             "tags": {"host": f"h{int(rng.integers(0, 4))}"}}
        if r < 0.05:
            d = ["not", "an", "object"]
        elif r < 0.1:
            d.pop("metric")
        elif r < 0.13:
            d["metric"] = 7
        elif r < 0.16:
            d["tags"] = "host=a"
        elif r < 0.19:
            d["tags"] = {"bad tag!": "x"}
        elif r < 0.22:
            d["timestamp"] = ("123abc", -5, 1 << 40, True, 1.5, None,
                              str(BT + i), float(BT + i))[
                int(rng.integers(0, 8))]
        elif r < 0.3:
            d["value"] = ("1.5", "nan", "x", True, None, 2.25, 1 << 70,
                          "12")[int(rng.integers(0, 8))]
        elif r < 0.35:
            d["tags"] = {}
        obj.append(d)
    return obj


def _batch_eq(a, b):
    for name in ("timestamps", "fvalues", "ivalues", "is_float", "sid"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.series == b.series
    assert a.errors == b.errors
    assert list(a.error_lines) == list(b.error_lines)
    assert a.consumed == b.consumed


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_json_puts_equal_on_mixed_bodies(seed):
    obj = _json_body(seed)
    got, want = pwire.decode_json_puts(obj), jwire.decode_json_puts(obj)
    _batch_eq(got, want)
    assert got.errors and len(got.sid) > 100


@pytest.mark.parametrize("body", [
    [{"metric": "a.b", "timestamp": BT + i, "value": i * 3,
      "tags": {"x": "y"}} for i in range(50)],
    [{"metric": "a.b", "timestamp": BT + i, "value": i * 0.5,
      "tags": {"x": str(i % 3)}} for i in range(50)],
    {"metric": "one", "timestamp": BT, "value": 1, "tags": {"t": "v"}},
    [],
])
def test_decode_json_puts_equal_on_homogeneous_bodies(body):
    _batch_eq(pwire.decode_json_puts(body), jwire.decode_json_puts(body))


def test_decode_json_puts_rejects_the_same_shapes():
    for obj in ("put a 1 1 x=y", 5, None):
        msgs = []
        for wire in (jwire, pwire):
            with pytest.raises(ValueError) as ei:
                wire.decode_json_puts(obj)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# Wire: the daemons
# ---------------------------------------------------------------------------

async def _telnet(port, lines, pause=False):
    """Send ``lines`` then ``exit``; everything the daemon answered.
    ``pause`` waits before the ``exit``, so a last ``put`` line is the
    per-line path's (nothing follows it yet), not the bulk path's."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(("\n".join(lines) + "\n").encode())
    await writer.drain()
    if pause:
        await asyncio.sleep(0.3)
    writer.write(b"exit\n")
    await writer.drain()
    out = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    return out


async def _http(port, target, method="GET", body=b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((f"{method} {target} HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Length: {len(body)}\r\n"
                  "Connection: close\r\n\r\n").encode() + body)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    head, _, resp = raw.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    hdrs = dict(ln.split(": ", 1) for ln in lines[1:])
    return int(lines[0].split()[1]), hdrs.get("Content-Type"), resp


def _serve(server, drive):
    async def main():
        await server.start()
        try:
            return await drive(server.port)
        finally:
            await server.stop()
    return asyncio.run(main())


def _jax_server(wal, **kw):
    return JaxServer(_jax_tsdb(wal, port=0, bind="127.0.0.1", **kw))


def _port_server(wal, **kw):
    return TSDServer(_port_tsdb(wal, port=0, bind="127.0.0.1", **kw))


def _lines(metric, n=40, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        v = (int(rng.integers(-9, 9)) if i % 3 else
             round(float(rng.normal(0, 5)), 3))
        out.append((metric, BT + i * 30, v, {"host": f"h{i % 4}",
                                             "dc": f"d{i % 2}"}))
    return out


def _put_line(m, t, v, tags, verb=True):
    tag = " ".join(f"{k}={x}" for k, x in tags.items())
    return f"{'put ' if verb else ''}{m} {t} {v} {tag}"


WIRE_SCRIPT = [
    ("telnet", ["tenant acme", f"put wire.m {BT} 1 id=0"]),
    ("telnet", ["tenant acme", f"put wire.m {BT} 1 id=1",
                f"put wire.m {BT + 60} 2 id=0"]),
    ("telnet", ["tenant", "tenant a b"]),
    ("telnet_alone", ["tenant acme", f"put wire.m {BT} 1 id=5"]),
    ("telnet", ["tenant bulk"] + [f"put bulk.m {BT + i} {i} id=0"
                                  for i in range(300)]
     + [f"put bulk.m {BT} 1 id=new{i}" for i in range(3)]),
    ("http", "/api/put?tenant=web", "POST", f"http.m {BT} 1 id=0\n"),
    ("http", "/api/put?tenant=web", "POST", f"http.m {BT} 1 id=1\n"),
    ("http", "/api/put?tenant=web", "POST",
     f"put http.m {BT + 60} 2 id=0\nput http.m {BT} 1 id=2\n"
     f"put http.m x 1 id=0\n"),
    ("http", "/api/put?tenant=js", "POST", json.dumps(
        [{"metric": "js.m", "timestamp": BT + i, "value": i,
          "tags": {"id": "0"}} for i in range(5)]
        + [{"metric": "js.m", "timestamp": BT, "value": 1,
            "tags": {"id": "1"}}, {"metric": "js.m"}])),
    ("http", "/api/put?tenant=js", "POST", json.dumps(
        {"metric": "js.m", "timestamp": BT, "value": 1,
         "tags": {"id": "9"}})),
    ("http", "/api/put", "GET", ""),
    ("http", "/api/put", "POST", "  \n"),
    ("http", "/api/put", "POST", "{nope"),
    ("http", "/api/put", "POST", "5"),
    ("http", "/api/put", "POST", '"text"'),
    ("http", "/api/tenants", "GET", ""),
    ("http", "/tenants", "GET", ""),
]


def _run_script(server, script):
    async def drive(port):
        out = []
        for step in script:
            if step[0].startswith("telnet"):
                out.append(await _telnet(port, step[1],
                                         step[0] == "telnet_alone"))
            else:
                _, target, method, body = step
                out.append(await _http(port, target, method,
                                       body.encode()))
        return out
    return _serve(server, drive)


def test_wire_faces_byte_identical_to_jax_daemon(tmp_path):
    """The same telnet and HTTP requests to both daemons under
    tenant_max_series=1: every telnet reply (the refusal lines, single
    and bulk, the tenant command's), every /api/put status and body (the
    429 naming the limit among them), /api/tenants and /tenants
    byte-identical, and the stores hold the same rows and UIDs."""
    j = _jax_server(str(tmp_path / "j"), tenant_max_series=1)
    p = _port_server(str(tmp_path / "p"), tenant_max_series=1)
    want = _run_script(j, WIRE_SCRIPT)
    got = _run_script(p, WIRE_SCRIPT)
    for step, g, w in zip(WIRE_SCRIPT, got, want):
        assert g == w, step[:2]
    assert (b"put: tenant series limit exceeded: wire.m: [tenant-limit] "
            b"tenant 'acme'") in got[1]
    assert b"throttle" not in got[1]
    assert got[2] == b"tenant: need exactly one id\n" * 2
    assert got[3] == (b"tenant acme\nput: tenant series limit exceeded: "
                      b"tenant 'acme' series limit exceeded: 1 >= 1 (new "
                      b"series refused; existing series keep ingesting)\n")
    assert got[4].count(b"put: tenant series limit exceeded: bulk.m: "
                        b"[tenant-limit]") == 3
    st, _, body = got[6]
    assert st == 429 and json.loads(body)["limit"] == 1
    assert "[tenant-limit]" in json.loads(body)["error"]
    assert got[7][0] == 200 and json.loads(got[7][2])["points"] == 1
    assert [g[0] for g in got[10:15]] == [405, 400, 400, 200, 200]
    info = json.loads(got[15][2])
    assert info["enabled"] and info["tenants"]["acme"]["refused"] == 2
    assert info["admission"] == {"tenants": 0, "evicted": 0,
                                 "collapsed": 0}
    assert got[16][0] == 200 and b"Tenant cardinality" in got[16][2]
    jt, pt = j.tsdb, p.tsdb
    jt2 = _jax_tsdb(str(tmp_path / "j"))
    pt2 = _port_tsdb(str(tmp_path / "p"))
    try:
        assert _dump(pt2) == _dump(jt2)
        assert _info(pt2) == _info(jt2)
    finally:
        jt2.shutdown()
        pt2.shutdown()
    assert jt._shutdown_done and pt._shutdown_done


@pytest.mark.parametrize("how", ["json", "lines", "bare_lines"])
def test_api_put_stores_the_bytes_telnet_put_does(tmp_path, how,
                                                 monkeypatch):
    """/api/put with a JSON body, with put lines, and with lines without
    the verb land the same rows, UIDs and tenant state as telnet puts of
    the same points on the connection's tenant; the JAX daemon's /api/put
    lands the same again.

    Both daemons decode put lines with the numpy decoder here, the JAX
    daemon's whenever its native library is not built. The native decoder
    of either package names a line's tags in sorted order, so a series
    whose tags arrive unsorted mints its tag UIDs in another order than
    JSON does (tests/test_torch_native.py holds the native telnet path
    against the JAX daemon's)."""
    monkeypatch.setattr(pwire, "_NATIVE", None)
    pts = _lines("put.m")
    if how == "json":
        body = json.dumps([{"metric": m, "timestamp": t, "value": v,
                            "tags": tags} for m, t, v, tags in pts])
    else:
        body = "\n".join(_put_line(*pt, verb=how == "lines")
                         for pt in pts)
    http = [("http", "/api/put?tenant=x", "POST", body)]
    telnet = [("telnet", ["tenant x"] + [_put_line(*pt) for pt in pts])]
    stores = []
    for name, make, script in (("a", _port_server, http),
                               ("b", _port_server, telnet),
                               ("c", _jax_server, http)):
        out = _run_script(make(str(tmp_path / name)), script)
        if script is http:
            st, _, resp = out[0]
            assert st == 200 and json.loads(resp)["points"] == len(pts)
        else:
            assert out[0] == b"tenant x\n"
        reopen = (_jax_tsdb if make is _jax_server else _port_tsdb)(
            str(tmp_path / name))
        stores.append((_dump(reopen), _info(reopen)))
        reopen.shutdown()
    assert stores[0] == stores[1] == stores[2]
    assert stores[0][1]["tenants"]["x"]["series"] == 4


# ---------------------------------------------------------------------------
# Tooling: tsd and tenants
# ---------------------------------------------------------------------------

def test_cmd_tsd_tunes_gc_once_after_the_store_opens(monkeypatch, tmp_path):
    calls = []
    open_tsdb = pcli.open_tsdb

    def recording_open(cfg, wal, **kw):
        calls.append("open")
        t = open_tsdb(cfg, wal, **kw)
        calls.append(("tenants", t.tenants is not None))
        return t

    class FakeServer:
        port = 0

        def __init__(self, tsdb):
            calls.append("server")
            self.tsdb = tsdb

        async def start(self):
            pass

        async def serve_forever(self):
            self.tsdb.shutdown()

        def request_shutdown(self):
            pass

    monkeypatch.setattr(pcli, "open_tsdb", recording_open)
    monkeypatch.setattr(pcli, "tune_for_ingest",
                        lambda: calls.append("tune"))
    monkeypatch.setattr("opentsdb_tpu_torch.server.tsd.TSDServer", FakeServer)
    assert pcli.main(["tsd", "--device", "cpu", "--port", "0",
                      "--wal", str(tmp_path / "wal"),
                      "--tenant-max-series", "3",
                      "--tenant-override", "a=0"]) == 0
    assert calls == ["open", ("tenants", True), "tune", "server"]


def test_tune_for_ingest_freezes_in_a_child_process():
    """gc.freeze is process-wide: checked in a child, never in pytest's
    own process."""
    import subprocess
    import sys
    code = ("import gc\n"
            "from opentsdb_tpu_torch.utils.gctune import tune_for_ingest\n"
            "junk = [[i] for i in range(1000)]\n"
            "tune_for_ingest()\n"
            "print(gc.get_freeze_count() > 1000, gc.get_threshold())\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    assert out.strip() == "True (50000, 20, 50)"


def _store_for_tools(wal):
    t = _jax_tsdb(wal, tenant_max_series=30, tenant_exact_cutoff=8)
    ts, val = np.asarray([BT], np.int64), np.asarray([1.0])
    for i in range(4):
        t.add_batch("cli.m", ts, val, {"id": str(i)}, tenant="ops")
    for i in range(20):
        t.add_batch("big.ns.m", ts + i, val, {"id": str(i)}, tenant="big")
    t.add_point("cli.m", BT, 2.0, {"id": "0"}, tenant="ops")
    t.shutdown()


@pytest.mark.parametrize("json_out", [False, True])
def test_tenants_subcommand_prints_what_jax_prints(tmp_path, capsys,
                                                   json_out):
    wal = str(tmp_path / "wal")
    _store_for_tools(wal)
    extra = ["--json"] if json_out else []
    outs = []
    for run in (lambda: jcli.main(["tenants", "--wal", wal, "--backend",
                                   "cpu"] + extra),
                lambda: pcli.main(["tenants", "--wal", wal, "--device",
                                   "cpu"] + extra),
                lambda: jcli.main(["tenants", "--wal", wal, "--backend",
                                   "cpu"] + extra)):
        assert run() == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] == outs[2]
    assert "big" in outs[1] and "ops" in outs[1]
    if not json_out:
        assert "tracked series: 24" in outs[1] and "hll±2%" in outs[1]


def test_tenants_url_form_reads_api_tenants(tmp_path, capsys):
    """``tenants --url`` of both packages against the port's daemon: the
    same report; ``--json`` is the /api/tenants body."""
    server = _port_server(str(tmp_path / "wal"), tenant_max_series=30)
    ready, done = threading.Event(), threading.Event()
    out = {}

    def run():
        async def main():
            await server.start()
            try:
                out["port"] = server.port
                await _telnet(server.port, ["tenant z"] + [
                    _put_line(*pt) for pt in _lines("url.m", 12)])
                ready.set()
                while not done.is_set():
                    await asyncio.sleep(0.05)
                out["api"] = (await _http(server.port, "/api/tenants"))[2]
            finally:
                ready.set()
                await server.stop()
        asyncio.run(main())

    th = threading.Thread(target=run)
    th.start()
    try:
        assert ready.wait(60)
        url = f"http://127.0.0.1:{out['port']}"
        texts = []
        for main in (jcli.main, pcli.main, jcli.main, pcli.main):
            extra = ["--json"] if len(texts) >= 2 else []
            assert main(["tenants", "--url", url] + extra) == 0
            texts.append(capsys.readouterr().out)
    finally:
        done.set()
        th.join(60)
    assert texts[0] == texts[1] and texts[2] == texts[3]
    assert "z" in texts[1]
    assert json.loads(texts[3]) == json.loads(out["api"])
