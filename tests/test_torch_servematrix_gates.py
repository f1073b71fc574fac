"""The port's serve matrix catches what it exists to catch, as
tests/test_servematrix.py requires of the JAX package's:
``TSDB_SERVE_BUG=stale-serve`` (a replica serving past its staleness
contract without the tag) fails the staleness oracle, and
``TSDB_CLUSTER_BUG=split-brain`` (a deposed writer unfenced and refusing
demotion) fails the zombie-fence scenario, each with a self-contained
repro line. The full sweep, twice with one seed for the fingerprints, is
marked slow as the JAX one is."""

import pytest

from test_torch_servematrix import run_matrix


def test_staleness_gate_catches_stale_serve(tmp_path):
    r, art = run_matrix(tmp_path, "--only", "staleness", "--bug",
                        "stale-serve")
    assert art is not None, r.stderr[-2000:]
    assert r.returncode != 0, \
        "a sabotaged replica passed the oracle: the gate is dead"
    res = art["results"][0]
    assert res["status"] == "invariant-failed"
    assert any("STALENESS CONTRACT VIOLATION" in p
               for p in res["problems"]), res["problems"]
    assert "--bug stale-serve" in res["repro"]
    assert "--device cpu" in res["repro"]


def test_split_brain_gate_catches_unfenced_zombie(tmp_path):
    r, art = run_matrix(tmp_path, "--only", "zombie-fence", "--bug",
                        "split-brain", timeout=600)
    assert art is not None, r.stderr[-2000:]
    assert r.returncode != 0, \
        "an unfenced zombie writer passed the matrix: the gate is dead"
    res = art["results"][0]
    assert res["status"] == "invariant-failed"
    assert any("SPLIT BRAIN" in p for p in res["problems"]), \
        res["problems"]
    assert "--bug split-brain" in res["repro"]


@pytest.mark.slow
def test_full_sweep_and_determinism(tmp_path):
    r1, a1 = run_matrix(tmp_path / "r1", timeout=900)
    assert r1.returncode == 0, (
        a1 and [x["problems"] for x in a1["results"]], r1.stderr[-2000:])
    assert a1["passed"] == a1["scenarios"] == 8
    r2, a2 = run_matrix(tmp_path / "r2", timeout=900)
    assert r2.returncode == 0
    f1 = {x["label"]: x["fingerprint"] for x in a1["results"]}
    f2 = {x["label"]: x["fingerprint"] for x in a2["results"]}
    assert f1 == f2, "the serve matrix is not seed-deterministic"
