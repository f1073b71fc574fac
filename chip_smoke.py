"""Smoke run of the PyTorch/CUDA port (opentsdb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every kernel of ``opentsdb_tpu_torch/csrc`` with nvcc for sm_90a
   (one nvcc per source, all started together).
3. Kernel phase: holds each CUDA kernel against its plain PyTorch version
   on the card, at the shapes the main path gives it, and times the
   kernel, the plain version and the one-call library yardstick with CUDA
   events (median of 20 runs), beside the least time the card needs for
   the bytes and operations.
4. Path phase: starts the port's daemon on loopback, ingests the repo's
   benchmark corpus (10,000 series x 1,000 points over 7 days = 10M
   points, bench.py gen_workload's shape) through ``TSDB.add_batch`` plus
   a few hundred telnet ``put`` lines, then answers five ``/q`` queries
   over HTTP. Kernel launch counts are zeroed just before and read just
   after, and every answer is checked against the float64 oracle
   (``ops/oracle.py``) on the same stored points.
5. Prints the card line first; at the end the per-query and ingest
   lines, the kernels line and, last, the ok line.

Any failure raises and exits nonzero before the last line. Without a CUDA
card, or without the package beside it, it exits nonzero and prints no
result. The full details go to standard error as one JSON line.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse

import numpy as np
import torch

from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.ops import cuda_build, segment_reduce
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.query.grammar import parse_m
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BASE = 1356998400             # hour-aligned epoch, as bench.py
SERIES, POINTS, SPAN = 10_000, 1_000, 7 * 86400
TELNET_SERIES, TELNET_POINTS = 20, 20
INTERVAL = 3600
QUERIES = ["sum:1h-avg:bench.metric",
           "sum:1h-avg:bench.metric{dc=*}",
           "max:1h-max:bench.metric{host=h00001}",
           "dev:1h-avg:bench.metric",
           "sum:rate:1h-avg:bench.metric"]
QUERY_REPS = 3
DEVICE = "cuda"


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def median_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work: bytes over HBM rate vs operations over
    the float32 peak, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# Corpus
# ---------------------------------------------------------------------------

def corpus(seed: int = 0):
    """bench.py gen_workload's corpus, drawn in bulk: regularly jittered
    timestamps (step = span / points, jitter < step / 2, so each row is
    strictly increasing) and random-walk float32 values from 100."""
    rng = np.random.default_rng(seed)
    step = SPAN // POINTS
    ts0 = np.arange(POINTS, dtype=np.int64) * step
    jitter = rng.integers(0, step // 2, (SERIES, POINTS))
    ts = BASE + np.minimum(ts0[None, :] + jitter, SPAN - 1)
    vals = (np.cumsum(rng.normal(0, 1.0, (SERIES, POINTS)), axis=1)
            + 100.0).astype(np.float32)
    return ts, vals


def series_tags(s: int) -> dict:
    return {"host": f"h{s:05d}", "dc": f"dc{s % 10}"}


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(ts: np.ndarray, vals: np.ndarray) -> tuple[list, list]:
    """Each kernel against its plain version at the path's shapes: the
    series stage of a 1h downsample over the whole corpus (N = 10M points
    into 16384 x 256 + 1 segments) and the group stage of a 10-dc
    group-by (16384 rows of [in_range | value | mask] x 256 buckets into
    16 groups)."""
    dev = torch.device(DEVICE)
    S, B = 16384, 256
    nseg = S * B + 1
    rel = (ts - BASE).reshape(-1)
    bucket = rel // INTERVAL
    sid = np.repeat(np.arange(SERIES), POINTS)
    seg = torch.from_numpy((sid * B + bucket).astype(np.int32)).to(dev)
    v = torch.from_numpy(vals.reshape(-1)).to(dev)
    feat = torch.stack([
        torch.ones_like(v), v,
        torch.from_numpy((rel - bucket * INTERVAL).astype(np.float32))
        .to(dev)], dim=1)
    rng = np.random.default_rng(1)
    rows = np.zeros((S, 3 * B), np.float32)
    rows[:SERIES, :B] = 1.0
    rows[:SERIES, B:2 * B] = 100 + rng.normal(0, 5, (SERIES, B))
    rows[:SERIES, 2 * B:] = 1.0
    gmap_np = np.full(S, 15, np.int32)
    gmap_np[:SERIES] = np.arange(SERIES) % 10
    rows_t = torch.from_numpy(rows).to(dev)
    gmap = torch.from_numpy(gmap_np).to(dev)

    cases = [
        ("segment_sum", "series stage", feat, seg, nseg),
        ("segment_sum", "group stage", rows_t, gmap, 16),
        ("segment_minmax", "series stage", v[:, None].contiguous(), seg,
         nseg),
        ("segment_minmax", "group stage", rows_t[:, B:2 * B].contiguous(),
         gmap, 16),
    ]
    results = []
    for name, stage, x, ids, ns in cases:
        n, k = x.shape
        if name == "segment_sum":
            got = segment_reduce.segment_sum(x, ids, ns)
            want = segment_reduce.segment_sum_plain(x, ids, ns)
            torch.cuda.synchronize()
            if stage == "series stage":
                # Counts and bucket-relative timestamp sums are integral
                # and below 2^24: exact. Value sums: float32, another
                # (run-dependent) order: rtol 1e-5.
                if not torch.equal(got[:, 0], want[:, 0]) \
                        or not torch.equal(got[:, 2], want[:, 2]):
                    fail(f"{name} {stage}: integral sums differ")
                torch.testing.assert_close(got[:, 1], want[:, 1],
                                           rtol=1e-5, atol=1e-5)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            err = float((got - want).abs().max())

            def library(x=x, ids=ids, ns=ns):
                return torch.zeros((ns, x.shape[1]), device=dev) \
                    .index_add_(0, ids, x)
            fn = segment_reduce.segment_sum
            plain = segment_reduce.segment_sum_plain
            nbytes = n * k * 4 + n * 4 + ns * k * 4
            ops = n * k
        else:
            got = segment_reduce.segment_minmax(x, ids, ns)
            want = segment_reduce.segment_minmax_plain(x, ids, ns)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                if not torch.equal(a, b):
                    fail(f"{name} {stage}: min/max not exact")
            err = max(float((a - b).abs().nan_to_num(0.0).max())
                      for a, b in zip(got, want) if a.numel())
            idx = ids.long()[:, None].expand(-1, k)

            def library(x=x, idx=idx, ns=ns):
                # Two scatter_reduce_ calls: no single PyTorch call
                # returns both.
                shape = (ns, x.shape[1])
                return (torch.full(shape, float("inf"), device=dev)
                        .scatter_reduce_(0, idx, x, "amin"),
                        torch.full(shape, float("-inf"), device=dev)
                        .scatter_reduce_(0, idx, x, "amax"))
            fn = segment_reduce.segment_minmax
            plain = segment_reduce.segment_minmax_plain
            nbytes = n * k * 4 + n * 4 + 2 * ns * k * 4
            ops = 2 * n * k
        b_ms, b_by = bound_ms(nbytes, ops)
        res = {
            "name": name, "stage": stage, "n": n, "k": k, "segments": ns,
            "max_abs_err": err,
            "ms": median_ms(lambda: fn(x, ids, ns)),
            "plain_ms": median_ms(lambda: plain(x, ids, ns)),
            "library_ms": median_ms(library),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        log(f"kernel {name} [{stage}] N={n} K={k} S={ns}: "
            f"{res['ms']:.4f} ms (plain {res['plain_ms']:.4f}, library "
            f"{res['library_ms']:.4f}, bound {b_ms:.4f} by {b_by}), "
            f"max_abs_err {err:g}")
        results.append(res)
    del feat, rows_t
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Path phase
# ---------------------------------------------------------------------------

class Daemon:
    """The port's TSD server on loopback, on its own event-loop thread."""

    def __init__(self, tsdb: TSDB) -> None:
        self.server = TSDServer(tsdb)
        self.loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._error: BaseException | None = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        if not self._started.wait(60) or self._error is not None:
            fail(f"daemon did not start: {self._error!r}")

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self.server.start())
        except BaseException as e:  # reported by __init__
            self._error = e
            self._started.set()
            return
        self._started.set()
        self.loop.run_until_complete(self.server.serve_forever())

    @property
    def port(self) -> int:
        return self.server.port

    def stop(self) -> None:
        self.loop.call_soon_threadsafe(self.server.request_shutdown)
        self.thread.join(120)
        if self.thread.is_alive():
            fail("daemon did not stop")


def telnet(port: int, lines: list[str]) -> str:
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(("\n".join(lines) + "\nversion\nexit\n").encode())
        chunks = []
        while True:
            data = s.recv(65536)
            if not data:
                break
            chunks.append(data)
    return b"".join(chunks).decode()


def http_get(port: int, target: str) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", target)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def spec_of(expr: str) -> QuerySpec:
    p = parse_m(expr)
    return QuerySpec(p.metric, p.tags, p.aggregator, p.rate, p.downsample,
                     p.counter, p.counter_max, p.reset_value)


def check_against_oracle(expr: str, got: list, want) -> float:
    """The JSON answer against the float64 oracle's results: same groups,
    tags and timestamps; values within rtol 1e-4 plus 1e-5 of the
    answer's largest magnitude (float32 sums over 10k series, in a
    run-dependent order; rate sums cancel across series, so a pure
    relative bound would be meaningless near zero). Returns the largest
    relative-to-scale error."""
    if len(got) != len(want):
        fail(f"{expr}: {len(got)} groups, oracle {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        if g["tags"] != w.tags:
            fail(f"{expr}: tags {g['tags']} vs oracle {w.tags}")
        ts = np.array([int(t) for t in g["dps"]], np.int64)
        vals = np.array(list(g["dps"].values()), np.float64)
        if not np.array_equal(ts, w.timestamps):
            fail(f"{expr}: timestamps differ from the oracle's")
        if not np.isfinite(vals).all() or len(vals) == 0:
            fail(f"{expr}: empty or non-finite answer")
        scale = float(np.abs(w.values).max())
        tol = 1e-4 * np.abs(w.values) + 1e-5 * scale
        err = np.abs(vals - w.values)
        if (err > tol).any():
            i = int(np.argmax(err - tol))
            fail(f"{expr}: value {vals[i]!r} vs oracle {w.values[i]!r} "
                 f"at {ts[i]}")
        worst = max(worst, float((err / max(scale, 1e-30)).max()))
    return worst


def path_phase(ts: np.ndarray, vals: np.ndarray, wal_dir: str) -> dict:
    tsdb = TSDB(MemKVStore(wal_path=os.path.join(wal_dir, "wal")),
                Config(auto_create_metrics=True, port=0, bind="127.0.0.1",
                       device=DEVICE),
                start_compaction_thread=True)
    daemon = Daemon(tsdb)
    out: dict = {"queries": {}}
    try:
        segment_reduce.segment_sum.launches = 0
        segment_reduce.segment_minmax.launches = 0
        t0 = time.perf_counter()
        for s in range(SERIES):
            tsdb.add_batch("bench.metric", ts[s], vals[s], series_tags(s))
        t_batch = time.perf_counter() - t0
        rng = np.random.default_rng(2)
        lines = []
        for s in range(TELNET_SERIES):
            tt = np.sort(rng.choice(SPAN, TELNET_POINTS, replace=False))
            for t, v in zip(tt + BASE, rng.normal(100, 1, TELNET_POINTS)):
                lines.append(f"put bench.metric {t} {v:.4f} host=t{s:02d} "
                             f"dc=dc{s % 10}")
        t1 = time.perf_counter()
        said = telnet(daemon.port, lines)
        t_telnet = time.perf_counter() - t1
        if "put:" in said or "opentsdb_tpu_torch" not in said:
            fail(f"telnet ingest answered: {said[:500]!r}")
        points = SERIES * POINTS + len(lines)
        out["ingest"] = {
            "points": points, "batch_s": t_batch, "telnet_s": t_telnet,
            "telnet_lines": len(lines),
            "points_per_s": points / (t_batch + t_telnet)}
        log(f"ingest: {points} points in {t_batch + t_telnet:.1f} s "
            f"({out['ingest']['points_per_s']:,.0f} points/s)")

        start, end = BASE, BASE + SPAN - 1
        answers = {}
        for expr in QUERIES:
            target = "/q?" + urllib.parse.urlencode(
                {"start": start, "end": end, "m": expr, "json": ""})
            before = (segment_reduce.segment_sum.launches,
                      segment_reduce.segment_minmax.launches)
            walls = []
            for _ in range(QUERY_REPS):
                q0 = time.perf_counter()
                status, body = http_get(daemon.port, target)
                walls.append((time.perf_counter() - q0) * 1e3)
                if status != 200:
                    fail(f"{expr}: HTTP {status}: {body[:300]!r}")
            launched = (segment_reduce.segment_sum.launches - before[0],
                        segment_reduce.segment_minmax.launches - before[1])
            answers[expr] = json.loads(body)
            out["queries"][expr] = {
                "p50_ms": statistics.median(walls), "wall_ms": walls,
                "launches_per_query": {
                    "segment_sum": launched[0] // QUERY_REPS,
                    "segment_minmax": launched[1] // QUERY_REPS}}
            log(f"query {expr}: p50 {statistics.median(walls):.1f} ms "
                f"(runs {', '.join(f'{w:.1f}' for w in walls)})")
        out["launches"] = {
            "segment_sum": segment_reduce.segment_sum.launches,
            "segment_minmax": segment_reduce.segment_minmax.launches}
        for name, n in out["launches"].items():
            if n == 0:
                fail(f"the main path never launched {name}")

        # Where a query's time goes (the host scan vs the device stage:
        # upload, kernels, download), in process, once per query; then
        # the HTTP answer against the float64 oracle (the port's copied
        # ops/oracle.py) on the same spans.
        ex = QueryExecutor(tsdb)
        oracle = QueryExecutor(tsdb, backend="cpu")
        for expr in QUERIES:
            spec = spec_of(expr)
            q = out["queries"][expr]
            s0 = time.perf_counter()
            groups = ex._find_spans(spec, start, end)
            s1 = time.perf_counter()
            ex._execute_groups(spec, groups, start, end)
            torch.cuda.synchronize()
            q["scan_ms"] = (s1 - s0) * 1e3
            q["execute_ms"] = (time.perf_counter() - s1) * 1e3
            q["oracle_rel_err"] = check_against_oracle(
                expr, answers[expr],
                oracle._execute_groups(spec, groups, start, end))
    finally:
        daemon.stop()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this smoke "
            "runs only on an NVIDIA card")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_build.build_all()
    build_s = time.perf_counter() - t0
    log(f"built {cuda_build.sources()} in {build_s:.1f} s")

    ts, vals = corpus()
    kernels = kernel_phase(ts, vals)
    with tempfile.TemporaryDirectory() as wal_dir:
        path = path_phase(ts, vals, wal_dir)

    line = []
    for res in kernels:
        if res["stage"] != "series stage":
            continue
        line.append({
            "name": res["name"], "route": "cuda",
            "source": "opentsdb_tpu_torch/csrc/segment_reduce.cu",
            "replaces": ("opentsdb_tpu/ops/pallas_kernels.py:77"
                         if res["name"] == "segment_sum"
                         else "opentsdb_tpu/ops/kernels.py:95"),
            "launches": path["launches"][res["name"]],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"]})
    log(json.dumps({"details": {
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "kernel_cases": kernels, "path": path}}))
    for expr, q in path["queries"].items():
        print(json.dumps({"query": expr, "p50_ms": q["p50_ms"],
                          "scan_ms": q["scan_ms"],
                          "execute_ms": q["execute_ms"],
                          "launches_per_query": q["launches_per_query"],
                          "card": smi}))
    print(json.dumps({"ingest_points_per_s":
                      path["ingest"]["points_per_s"], "card": smi}))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
