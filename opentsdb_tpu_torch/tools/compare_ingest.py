"""Time the ingest of several checkouts of this repo against each other on
one NVIDIA card, each in its own process.

    git archive <rev> | tar -x -C DIR      # one directory per revision
    python -m opentsdb_tpu_torch.tools.compare_ingest DIR [DIR ...]

Each run imports DIR's own package and ``chip_smoke.py``, builds DIR's
kernels, opens a TSDB with the default ``Config`` on the card (the
resident window mirroring every write, the live sketches folding every
value, the compaction thread running) over a WAL in a temporary
directory, and times ``TSDB.add_batch`` over chip_smoke.py's corpus
(10,000 series x 1,000 points over 7 days, seed 0), the smoke's ingest
without its few hundred telnet lines; then the replay of a copy of that
WAL into a bare ``MemKVStore`` (the recovery a crash before the first
checkpoint would pay) and ``TSDB.checkpoint()`` of the ingested store (the
spill of every row). With ``--tune`` each run freezes its heap and raises
the collector's thresholds once the store is open, as ``tsdb tsd`` does
(``utils/gctune.py``; the revision must have it). The revisions run in
turns A B .. B A, ``--rounds`` times (default 2). One JSON line per run goes to standard output after the
card's name and power limit, then one line with each DIR's medians:
points/s, replay seconds and checkpoint seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import json, os, shutil, sys, tempfile, time
import chip_smoke as cs
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.ops import cuda_build
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config

cuda_build.build_all()
ts, vals = cs.corpus()
with tempfile.TemporaryDirectory() as d:
    tsdb = TSDB(MemKVStore(wal_path=os.path.join(d, "wal")),
                Config(auto_create_metrics=True), start_compaction_thread=True)
    if sys.argv[1:] == ["tune"]:
        from opentsdb_tpu_torch.utils.gctune import tune_for_ingest
        tune_for_ingest()
    t0 = time.perf_counter()
    for s in range(cs.SERIES):
        tsdb.add_batch("bench.metric", ts[s], vals[s], cs.series_tags(s))
    secs = time.perf_counter() - t0
    tsdb.compactionq.shutdown()
    tsdb.store.flush()
    shutil.copyfile(os.path.join(d, "wal"), os.path.join(d, "copy"))
    t0 = time.perf_counter()
    again = MemKVStore(wal_path=os.path.join(d, "copy"))
    replay_s = time.perf_counter() - t0
    again.close()
    del again
    t0 = time.perf_counter()
    rows = tsdb.checkpoint()
    checkpoint_s = time.perf_counter() - t0
    tsdb.store.close()
points = int(ts[:cs.SERIES].size)
print(json.dumps({"points": points, "seconds": secs,
                  "points_per_s": points / secs, "replay_s": replay_s,
                  "checkpoint_rows": rows, "checkpoint_s": checkpoint_s}))
"""


def run_once(d: str, tune: bool = False) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(d))
    out = subprocess.run([sys.executable, "-c", _CHILD,
                          *(["tune"] if tune else [])], cwd=d, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=1200).stdout
    return json.loads(out.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--tune", action="store_true",
                    help="freeze each run's heap as tsdb tsd does")
    args = ap.parse_args(argv)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    order = args.dirs + args.dirs[::-1]
    keys = ("points_per_s", "replay_s", "checkpoint_s")
    runs: dict[str, dict[str, list[float]]] = {
        d: {k: [] for k in keys} for d in args.dirs}
    for rnd in range(args.rounds):
        for turn, d in enumerate(order):
            r = run_once(d, args.tune)
            for k in keys:
                runs[d][k].append(r[k])
            print(json.dumps({"dir": d, "round": rnd, "turn": turn, **r}),
                  flush=True)
    print(json.dumps({
        **{f"median_{k}": {d: statistics.median(v[k])
                           for d, v in runs.items()} for k in keys},
        "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
