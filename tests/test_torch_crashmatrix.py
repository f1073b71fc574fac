"""The port's crash-consistency matrix (opentsdb_tpu_torch/fault/harness.py):
the tier-1 fast subset, the caught ack-before-fsync bug, determinism, a
crashed store recovered by both packages, and the full sweep (slow).

Every scenario spawns a child process that runs the seeded workload on
the port, dies at the armed failpoint (os._exit, SIGKILL semantics), and
is verified by the parent: recovery, fsck clean, raw golden parity
against the oracle, tenant accounting and, with the rollup tier (the JAX
matrix's default), rollup-served answers bit-identical to raw ones. The
re-introduced torn rollup bracket must fail the matrix."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest

import opentsdb_tpu.fault.harness as jax_harness
from opentsdb_tpu.tools.fsck import run_fsck as jax_fsck
from opentsdb_tpu_torch.fault import faultpoints, harness
from opentsdb_tpu_torch.tools.fsck import run_fsck as port_fsck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _by_label():
    """The matrix rows, run on the CPU (the harness defaults to the card)."""
    return {s.label: dataclasses.replace(s, device="cpu")
            for s in harness.build_matrix()}


def test_matrix_shape():
    scens = harness.build_matrix()
    assert len({s.label for s in scens}) == len(scens) >= 40
    assert {s.shards for s in scens} == {1, 4}
    assert {s.site for s in scens} == {
        "kv.wal.append", "kv.wal.fsync", "kv.wal.group.write",
        "kv.wal.group.fsync", "kv.checkpoint.freeze",
        "kv.checkpoint.commit", "kv.checkpoint.manifest",
        "sst.write.body", "sst.write.footer", "sst.write.block",
        "sst.rename",
        "tenant.snapshot.write", "tenant.snapshot.commit",
        "sharded.spill.shard", "rollup.begin_spill", "rollup.fold.start",
        "rollup.fold.flush", "rollup.fold.commit", "rollup.bracket.flip",
        "replica.refresh", "replica.rebuild", "cluster.promote.take",
        "cluster.promote.rotate", "mesh.reshard.commit"}
    # Every port row is the JAX matrix's row of the same label (its site,
    # mode, skip, shards, seed and rollup settings).
    jax = {s.label: s for s in jax_harness.build_matrix()}
    for s in scens:
        j = jax[s.label]
        assert (s.site, s.mode, s.skip, s.shards, s.seed, s.n_ops,
                s.wal_group_ms, s.tenant_cutoff, s.codec, s.rollups,
                s.delete_heavy, s.catchup_compare, s.kind) == \
            (j.site, j.mode, j.skip, j.shards, j.seed, j.n_ops,
             j.wal_group_ms, j.tenant_cutoff, j.codec, j.rollups,
             j.delete_heavy, j.catchup_compare, j.kind), s.label
    # Every row of the JAX matrix, its meshreshard kind included.
    assert {s.label for s in scens} == set(jax)
    assert sorted(s.label for s in scens
                  if s.kind not in ("crash", "meshreshard")) == sorted(
        INPROCESS_LABELS)
    # Every TSST4 row of the JAX matrix that needs no rollup tier.
    assert sorted(s.label for s in scens if s.codec == "tsst4") == sorted(
        s.label for s in jax.values()
        if s.codec == "tsst4" and s.label in {x.label for x in scens})
    assert {s.label for s in scens if s.codec == "tsst4"} == {
        "sst-block-crash-s1", "sst-block-crash-s4", "sst-block-torn-s1",
        "sst-block-torn-s4", "sst-block-torn-late-s1",
        "sst-block-torn-late-s4", "sst-block-torn-norollup",
        "sst-block-torn-norollup-s4"}
    assert len(harness.fast_matrix()) == len(harness.FAST_LABELS) == 16
    assert sum(s.site.startswith("rollup.") for s in scens) == 16


def test_workload_is_the_jax_workload():
    for seed, n, heavy in ((7, 24, False), (1001, 36, False),
                           (77, 36, True)):
        assert harness.gen_ops(seed, n, heavy) == \
            jax_harness.gen_ops(seed, n, heavy)
    assert harness.gen_ops(7, 24) != harness.gen_ops(8, 24)


@pytest.mark.parametrize("label", harness.FAST_LABELS)
def test_fast_scenario(label, tmp_path):
    sc = _by_label()[label]
    res = harness.run_scenario(sc, str(tmp_path), shrink=False)
    assert res["status"] == "ok", (res["problems"], res)
    # A crash row's child died at the armed site; an in-process row
    # (replica, promote) has no child.
    assert res["child_exit"] == (faultpoints.EXIT_CODE
                                 if sc.kind in ("crash", "meshreshard")
                                 else None)


def test_meshreshard_row_matches_jax(tmp_path):
    """The meshreshard row in both harnesses: each child dies at the
    reshard commit gate after the same acknowledged ops, and each
    verifier's rewarm, resident parity and finished reshard pass."""
    sc = _by_label()["meshreshard-commit-crash"]
    res = harness.run_scenario(sc, str(tmp_path / "port"), shrink=False)
    jsc = {s.label: s for s in jax_harness.build_matrix()}[sc.label]
    jres = jax_harness.run_scenario(jsc, str(tmp_path / "jax"),
                                    shrink=False)
    assert res["status"] == jres["status"] == "ok", (res["problems"],
                                                     jres["problems"])
    assert res["ops_done"] == jres["ops_done"]
    assert res["child_exit"] == jres["child_exit"] == faultpoints.EXIT_CODE


INPROCESS_LABELS = (
    "replica-refresh-ioerror", "replica-rebuild-raise",
    "replica-rebuild-raise-s4", "promote-take-raise",
    "promote-rotate-raise", "promote-rotate-raise-s4",
    "promote-rotate-ioerror")


def _dump_with(harness_mod, dirpath, shards):
    s = harness_mod.open_store(dirpath, shards, read_only=True)
    try:
        return harness_mod._dump_store(s)
    finally:
        s.close()


@pytest.mark.parametrize("label", INPROCESS_LABELS)
def test_inprocess_row_crosses_to_jax(label, tmp_path):
    """Each replica / promote row runs in the port and, with its seed, in
    the JAX harness; both pass, and each package, reading the other's
    final store as a replica, dumps what the other's own reader dumps."""
    sc = _by_label()[label]
    res = harness.run_scenario(sc, str(tmp_path / "port"), shrink=False)
    assert res["status"] == "ok", res["problems"]
    jsc = {s.label: s for s in jax_harness.build_matrix()}[label]
    jres = jax_harness.run_scenario(jsc, str(tmp_path / "jax"),
                                    shrink=False)
    assert jres["status"] == "ok", jres["problems"]
    pdir = str(tmp_path / "port" / label / "store")
    jdir = str(tmp_path / "jax" / label / "store")
    assert _dump_with(jax_harness, pdir, sc.shards) == \
        _dump_with(harness, pdir, sc.shards)
    assert _dump_with(harness, jdir, sc.shards) == \
        _dump_with(jax_harness, jdir, sc.shards)
    assert _dump_with(harness, pdir, sc.shards) == \
        _dump_with(harness, jdir, sc.shards)


@pytest.mark.slow
@pytest.mark.parametrize("label", [
    "sst-block-crash-s1", "sst-block-crash-s4", "sst-block-torn-s4",
    "sst-block-torn-late-s1", "sst-block-torn-late-s4",
    "sst-block-torn-norollup", "sst-block-torn-norollup-s4"])
def test_tsst4_scenario(label, tmp_path):
    """The TSST4 rows outside the fast subset: a crash or cut inside a
    compressed block, recovered with the v4 writers and fsck's block
    audit."""
    sc = _by_label()[label]
    res = harness.run_scenario(sc, str(tmp_path), shrink=False)
    assert res["status"] == "ok", (res["problems"], res)
    assert res["child_exit"] == faultpoints.EXIT_CODE


def test_reintroduced_torn_bracket_bug_is_caught(tmp_path):
    """The rollup gate: re-introduce the torn spill bracket in the child
    (begin_spill never opens it, the pending marker is never written)
    and crash between the spill-key drain and the fold. The matrix must
    catch the stale rollup answers, and the shrinker a smaller failing
    schedule; the same scenario without the bug passes (a fast row)."""
    sc = dataclasses.replace(_by_label()["rollup-foldstart-crash-s1"],
                             label="bug-torn-bracket", bug="torn-bracket")
    res = harness.run_scenario(sc, str(tmp_path), shrink=True)
    assert res["status"] == "invariant-failed", res
    assert any("rollup-served answer != raw answer" in p
               or "group sets differ" in p
               for p in res["problems"]), res["problems"]
    assert res["min_repro"] and res["min_repro"]["n_ops"] < sc.n_ops
    assert "--site rollup.fold.start" in res["repro"]
    assert "--bug torn-bracket" in res["repro"]


def test_reintroduced_ack_before_fsync_bug_is_caught(tmp_path):
    """Sabotage the WAL barrier (MemKVStore._ACK_BEFORE_FSYNC) so appends
    acknowledge before their covering group flush, crash at the buffered
    group write: verify must flag acknowledged rows that are gone, and
    the shrinker must find a smaller failing schedule. The same scenario
    without the bug passes."""
    clean = _by_label()["wal-group-write-crash-s1"]
    res = harness.run_scenario(clean, str(tmp_path / "clean"),
                               shrink=False)
    assert res["status"] == "ok", res["problems"]
    sc = dataclasses.replace(clean, label="bug-ack-before-fsync",
                             bug="ack-before-fsync")
    res = harness.run_scenario(sc, str(tmp_path / "bug"), shrink=True)
    assert res["status"] == "invariant-failed", res
    # Acknowledged ops are gone: their rows, or even their UIDs.
    assert any("missing" in p for p in res["problems"]), res["problems"]
    assert res["min_repro"] and res["min_repro"]["n_ops"] < sc.n_ops
    for flag in ("--site kv.wal.group.write", "--bug ack-before-fsync",
                 "--wal-group-ms 2.0"):
        assert flag in res["repro"]


def test_same_seed_same_fingerprint(tmp_path):
    """Two runs of one scenario, the second through the module's command
    line with its JSON artifact: the same fingerprint and ops done."""
    sc = _by_label()["ckpt-commit-crash-s4"]
    r1 = harness.run_scenario(sc, str(tmp_path / "a"), shrink=False)
    out = tmp_path / "matrix.json"
    proc = subprocess.run(
        [sys.executable, "-m", "opentsdb_tpu_torch.fault.harness",
         "--only", "ckpt-commit-crash-s4", "--device", "cpu",
         "--json", str(out),
         "--work-dir", str(tmp_path / "b")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    art = json.loads(out.read_text())
    assert art["scenarios"] == art["passed"] == 1
    (r2,) = art["results"]
    assert r1["status"] == r2["status"] == "ok"
    assert r1["fingerprint"] == r2["fingerprint"]
    assert r1["ops_done"] == r2["ops_done"] > 0


def test_child_scenarios_reject_inprocess_modes(tmp_path):
    sc = harness.Scenario(label="bad-mode", site="kv.wal.fsync",
                          mode="delay", device="cpu")
    with pytest.raises(ValueError, match="crash/torn"):
        harness.run_scenario(sc, str(tmp_path))


def test_unreachable_site_reports_not_hit(tmp_path):
    """Group-commit sites without group commit never fire: reported, not
    counted as covered."""
    sc = harness.Scenario(label="unreachable", site="kv.wal.group.write",
                          mode="crash", n_ops=8, device="cpu")
    res = harness.run_scenario(sc, str(tmp_path), shrink=False)
    assert res["status"] == "not-hit"


def _rows(store):
    return {tb: list(store.scan_raw(tb, b"", b""))
            for tb in ("tsdb", "tsdb-uid")}


def _rollup_cells(tsdb):
    tier = tsdb.rollups
    return {(r, si, bytes(k), bytes(q)): bytes(v)
            for r, stores in tier.stores.items()
            for si, s in enumerate(stores)
            for k, items in s.scan_raw(tier.table, b"", b"", family=b"r")
            for q, v in items}


def test_crashed_store_recovers_alike_in_both_packages(tmp_path):
    """The port's child dies mid-spill in a 4-shard store (after two of
    four shards); a copy of the crashed directory is recovered by each
    package: the same rows, fsck clean in both, the same rollup cells
    after each caught its tier up, and the port's verify holds every
    invariant."""
    sc = _by_label()["shard-join-crash-k2"]
    work = tmp_path / "w"
    store = work / "store"
    os.makedirs(work)
    env = dict(os.environ)
    env[faultpoints.ENV_VAR] = faultpoints.format_spec(
        sc.site, sc.mode, skip=sc.skip, count=sc.count, seed=sc.seed)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        harness.child_command(sc, str(store), str(work / "progress")),
        env=env, capture_output=True, timeout=harness.CHILD_TIMEOUT)
    assert proc.returncode == faultpoints.EXIT_CODE, proc.stderr[-2000:]
    done, finished = harness._read_progress(str(work / "progress"))
    assert 0 < done and not finished
    for name in ("port", "jax"):
        shutil.copytree(store, tmp_path / name)
    pt = harness.open_tsdb(str(tmp_path / "port"), sc.shards, device="cpu")
    jt = jax_harness.open_tsdb(str(tmp_path / "jax"), sc.shards,
                               rollups=sc.rollups)
    try:
        assert _rows(pt.store) == _rows(jt.store)
        assert port_fsck(pt).errors == jax_fsck(jt).errors == 0
        assert pt.tenants.total_tracked() == jt.tenants.total_tracked()
        # Both caught the rollup tier up over the crash alike.
        assert pt.rollups.ready and jt.rollups.ready
        assert _rollup_cells(pt) == _rollup_cells(jt)
    finally:
        pt.shutdown()
        jt.shutdown()
    problems, _ = harness.verify(
        str(store), sc, harness.gen_ops(sc.seed, sc.n_ops), done)
    assert problems == []


@pytest.mark.slow
def test_full_matrix(tmp_path):
    results = harness.run_matrix(list(_by_label().values()), str(tmp_path),
                                 shrink=False)
    bad = [(r["label"], r["status"], r["problems"][:2])
           for r in results if r["status"] != "ok"]
    assert len(results) >= 40
    assert not bad, bad
