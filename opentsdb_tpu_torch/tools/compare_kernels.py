"""Time the segment-reduce kernels of several checkouts of this repo against
each other on one NVIDIA card, at the group-stage shapes of the query path.

    git archive <rev> | tar -x -C DIR      # one directory per revision
    python -m opentsdb_tpu_torch.tools.compare_kernels DIR [DIR ...]

Each DIR's ``opentsdb_tpu_torch/csrc/segment_reduce.cu`` is built with nvcc
(the port's own flags, all builds started together) and called through its
C interface, so revisions whose wrappers differ compare on the same inputs.
Each case is checked against ``index_add_`` / ``scatter_reduce_`` and timed
as device time per call: 20 calls queued back to back behind a GPU sleep,
the output filled before the calls and not refilled. The revisions run in
turns A B .. B A, twice. ``segment_minmax_f32`` is asked for both outputs,
the one request every revision answers. One JSON line per case goes to
standard output, after the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from opentsdb_tpu_torch.ops.cuda_build import NVCC_FLAGS, _nvcc

SOURCE = os.path.join("opentsdb_tpu_torch", "csrc", "segment_reduce.cu")
S, B, SERIES = 16384, 256, 10_000    # chip_smoke.py's group stage


def build(dirs: list[str]) -> list[ctypes.CDLL]:
    jobs = []
    for d in dirs:
        out = os.path.join(d, "_compare_segment_reduce.so")
        jobs.append((out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(d, SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = []
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    for out, proc in jobs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {out}:\n{log}")
        lib = ctypes.CDLL(os.path.abspath(out))
        lib.segment_sum_f32.argtypes = [p, p, i64, i32, i64, p, p]
        lib.segment_minmax_f32.argtypes = [p, p, i64, i32, i64, p, p, p]
        libs.append(lib)
    return libs


def device_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def cases(seed: int = 1):
    """(op, label, rows, gmap, groups): the group stage of chip_smoke.py's
    corpus, by the executor's layout (gmap sorted, padding rows in the last
    group; empty rows hold 0 for sums and -inf for max)."""
    rng = np.random.default_rng(seed)
    real = (100 + rng.normal(0, 5, (SERIES, B))).astype(np.float32)
    rows = np.zeros((S, 3 * B), np.float32)
    rows[:SERIES, :B] = 1.0
    rows[:SERIES, B:2 * B] = real
    rows[:SERIES, 2 * B:] = 1.0
    vals = np.full((S, B), -np.inf, np.float32)
    vals[:SERIES] = real
    dc = np.full(S, 15, np.int32)
    dc[:SERIES] = np.arange(SERIES) % 10
    host = np.full(S, S - 1, np.int32)
    host[:SERIES] = np.arange(SERIES)
    runs = np.ones((S, 3 * B), np.float32)
    runs[:, B:2 * B] = 100 + rng.normal(0, 5, (S, B))
    return [
        ("sum", "{dc=*}: 16 groups", rows, dc, 16),
        ("minmax", "{dc=*}: 16 groups", vals, dc, 16),
        ("sum", "{host=*}: 16384 groups, 1 series each", rows, host, S),
        ("minmax", "{host=*}: 16384 groups, 1 series each", vals, host, S),
        ("sum", "1024 groups, 16 series each", runs,
         (np.arange(S) // 16).astype(np.int32), 1024),
    ]


def main(dirs: list[str]) -> int:
    if not dirs or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    libs = build(dirs)
    dev = torch.device("cuda")
    order = list(range(len(dirs)))
    order = order + order[::-1]
    for op, label, x_np, g_np, ns in cases():
        x = torch.from_numpy(x_np).to(dev)
        g = torch.from_numpy(g_np).to(dev)
        n, k = x.shape
        idx = g.long()[:, None].expand(-1, k)
        shape = (ns, k)
        if op == "sum":
            want = (torch.zeros(shape, device=dev).index_add_(0, g.long(), x),)
            outs = (torch.zeros(shape, device=dev),)
        else:
            want = (torch.full(shape, float("inf"), device=dev)
                    .scatter_reduce_(0, idx, x, "amin"),
                    torch.full(shape, float("-inf"), device=dev)
                    .scatter_reduce_(0, idx, x, "amax"))
            outs = (torch.empty(shape, device=dev),
                    torch.empty(shape, device=dev))

        def call(lib, outs=outs, x=x, g=g, n=n, k=k, ns=ns, op=op):
            fn = lib.segment_sum_f32 if op == "sum" else lib.segment_minmax_f32
            rc = fn(x.data_ptr(), g.data_ptr(), n, k, ns,
                    *(o.data_ptr() for o in outs),
                    torch._C._cuda_getCurrentRawStream(dev.index or 0))
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc}")

        def fill(outs=outs, op=op):
            if op == "sum":
                outs[0].zero_()
            else:
                outs[0].fill_(float("inf"))
                outs[1].fill_(float("-inf"))

        errs = []
        for lib in libs:
            fill()
            call(lib)
            torch.cuda.synchronize()
            for got, w in zip(outs, want):
                torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)
            errs.append(max(float((o - w).abs().nan_to_num(0.0).max())
                            for o, w in zip(outs, want)))
        times: list[list[float]] = [[] for _ in dirs]
        for _ in range(2):
            for i in order:
                fill()
                times[i].append(device_ms(lambda lib=libs[i]: call(lib)))
        print(json.dumps({
            "op": op, "case": label, "n": n, "k": k, "groups": ns,
            "card": smi, "revisions": [
                {"dir": d, "device_ms": t, "median_ms": float(np.median(t)),
                 "max_abs_err": e}
                for d, t, e in zip(dirs, times, errs)]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
