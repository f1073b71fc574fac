"""The port's serve matrix (``opentsdb_tpu_torch/tools/servematrix.py``):
its fast subset on the CPU, as tests/test_servematrix.py runs the JAX
package's. Every daemon is a process of the port's CLI (``--device
cpu``): a writer, two tailing replicas and a router (``tsd --role
router``). The five scenarios: a replica killed mid-query (the router
retries onto the other, the answer the writer's), a partitioned replica
(ejected, its queries served by the other within the deadline,
readmitted), the writer killed (the router promotes a replica past the
grace and forwards puts to it; every acked point survives), a wedged
writer deposed and then demoted on waking (its put refused), and the
degraded step (``degrade=rollup-only`` through the router: a percentile
within its bound of the writer's exact answer, a raw-only query 503). The
sabotage gates and the full sweep are in test_torch_servematrix_gates.py,
so that the two files run side by side."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_matrix(tmp_path, *args, timeout=420):
    out_json = str(tmp_path / "serve.json")
    r = subprocess.run(
        [sys.executable, "-m", "opentsdb_tpu_torch.tools.servematrix",
         "--device", "cpu", "--json", out_json,
         "--work-dir", str(tmp_path / "work")] + list(args),
        capture_output=True, text=True, timeout=timeout, cwd=REPO)
    art = None
    if os.path.exists(out_json):
        with open(out_json) as f:
            art = json.load(f)
    return r, art


def test_fast_scenarios_pass(tmp_path):
    r, art = run_matrix(tmp_path, "--fast", timeout=700)
    assert art is not None, r.stderr[-2000:]
    assert r.returncode == 0, (
        [x["problems"] for x in art["results"]], r.stderr[-2000:])
    assert art["passed"] == art["scenarios"] == 5
    assert art["device"] == "cpu"
    assert {x["label"] for x in art["results"]} == {
        "replica-kill", "router-partition", "writer-promote",
        "zombie-fence", "degraded-approx"}
