"""The port's crash-consistency matrix (opentsdb_tpu_torch/fault/harness.py):
the tier-1 fast subset, the caught ack-before-fsync bug, determinism, a
crashed store recovered by both packages, and the full sweep (slow).

Every scenario spawns a child process that runs the seeded workload on
the port, dies at the armed failpoint (os._exit, SIGKILL semantics), and
is verified by the parent: recovery, fsck clean, raw golden parity
against the oracle, and tenant accounting."""

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
        "sharded.spill.shard"}
    # Every port row is the JAX matrix's row of the same label (its site,
    # mode, skip, shards and seed), rollups off.
    jax = {s.label: s for s in jax_harness.build_matrix()}
    for s in scens:
        j = jax[s.label]
        assert (s.site, s.mode, s.skip, s.shards, s.seed, s.n_ops,
                s.wal_group_ms, s.tenant_cutoff, s.codec) == \
            (j.site, j.mode, j.skip, j.shards, j.seed, j.n_ops,
             j.wal_group_ms, j.tenant_cutoff, j.codec), s.label
    # Every TSST4 row of the JAX matrix that needs no rollup tier.
    assert sorted(s.label for s in scens if s.codec == "tsst4") == sorted(
        s.label for s in jax.values()
        if s.codec == "tsst4" and s.label in {x.label for x in scens})
    assert {s.label for s in scens if s.codec == "tsst4"} == {
        "sst-block-crash-s1", "sst-block-crash-s4", "sst-block-torn-s1",
        "sst-block-torn-s4", "sst-block-torn-late-s1",
        "sst-block-torn-late-s4", "sst-block-torn-norollup",
        "sst-block-torn-norollup-s4"}
    assert len(harness.fast_matrix()) == len(harness.FAST_LABELS) == 9


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
    assert res["child_exit"] == faultpoints.EXIT_CODE


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


def test_crashed_store_recovers_alike_in_both_packages(tmp_path):
    """The port's child dies mid-spill in a 4-shard store (after two of
    four shards); a copy of the crashed directory is recovered by each
    package: the same rows, fsck clean in both, and the port's verify
    holds every invariant."""
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
                               rollups=False)
    try:
        assert _rows(pt.store) == _rows(jt.store)
        assert port_fsck(pt).errors == jax_fsck(jt).errors == 0
        assert pt.tenants.total_tracked() == jt.tenants.total_tracked()
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
