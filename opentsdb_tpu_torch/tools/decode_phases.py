"""Where a tile of the block-decode kernel spends its time, on the card.

    python -m opentsdb_tpu_torch.tools.decode_phases

Builds a copy of ``csrc/block_decode.cu`` with ``%globaltimer`` stamps
(thread 0 of each tile, at the end of each phase) and counters in the
look-back (rounds of 32 tiles, the most spins of a polling lane, the lane
of the nearest inclusive prefix), runs it on compare_kernels' synthetic
gathers (the week's, day's and TSINT week's sizes), and prints the card's
name and power limit, then one JSON line per gather: the most tiles in
flight at once, the span of the launch, and the median and 90th
percentile of each phase and of a tile's life in microseconds, and the
look-backs' counts. The outputs are checked against decode_points_plain.
The stamps are a few stores a tile; compare_kernels times the kernel
without them.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from opentsdb_tpu_torch.ops import block_decode
from opentsdb_tpu_torch.ops.cuda_build import CSRC, NVCC_FLAGS, _nvcc
from opentsdb_tpu_torch.tools.compare_kernels import decode_inputs

STAMPS = 12  # words a tile: 9 stamps, 2 look-back counts
PHASES = ("tile counter", "loads + offsets scan", "offsets look-back",
          "payload staging", "gather + C/W scan", "steps + S scan",
          "C/W/S look-back", "values + rel_ts")
# (anchor, code inserted before it); each anchor must occur once.
PATCHES = [
    ("namespace {\n\nconstexpr int kThreads",
     "__device__ unsigned long long* g_dbg;\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  const int64_t n = a.n;\n  if (tid == 0) {\n    unsigned* counter",
     "  const unsigned long long t_begin = gtime();\n"),
    ("  const int j0 = tid * kItems;",
     "  unsigned long long* D = g_dbg + (size_t)tile * 12;\n"
     "  if (tid == 0) { D[0] = t_begin; D[1] = gtime(); }\n"),
    ("  if (tid == 0) {\n    agg[0] = tot1.x;", "  if (tid == 0) D[2] = gtime();\n"),
    ("  uint32_t lead_ts = 0u, lead_v = 0u;", "  if (tid == 0) D[3] = gtime();\n"),
    ("  uint32_t e[kItems], w[kItems];", "  if (tid == 0) D[4] = gtime();\n"),
    ("  // The windows are dead", "  if (tid == 0) D[5] = gtime();\n"),
    ("  resolve<Chains<OpW>>(", "  if (tid == 0) D[6] = gtime();\n"),
    ("  irregular |= q_hi >= 0", "  if (tid == 0) D[7] = gtime();\n"),
    ("  if (irregular) st_relaxed(state + 1, tag);\n}",
     "  if (tid == 0) D[8] = gtime();\n"),
    ("  for (int pos = tile - 1;; pos -= 32) {",
     "  int rounds = 0, spins = 0;\n"),
    ("    const int t = pos - lane;", "    ++rounds;\n"),
    ("__nanosleep(32);", "++spins, "),
    ("    if (m) return;\n",
     "    {\n      const int ms = __reduce_max_sync(0xffffffffu, spins);\n"
     "      if (m && lane == 0)\n"
     "        g_dbg[(size_t)tile * 12 + (K == 2 ? 9 : 10)] =\n"
     "            rounds * 1000000ull + p * 1000ull + (ms > 999 ? 999 : ms);\n"
     "    }\n"),
]


def instrumented_source() -> str:
    with open(os.path.join(CSRC, "block_decode.cu")) as f:
        src = f.read()
    for anchor, code in PATCHES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, code + anchor)
    return src + ('\nextern "C" int set_debug(unsigned long long* p) {\n'
                  "  return (int)cudaMemcpyToSymbol(g_dbg, &p, sizeof(p));\n"
                  "}\n")


def build(workdir: str) -> ctypes.CDLL:
    cu = os.path.join(workdir, "block_decode_phases.cu")
    so = os.path.join(workdir, "libblock_decode_phases.so")
    with open(cu, "w") as f:
        f.write(instrumented_source())
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    for name in ("block_decode_state_words", "block_decode_scratch_words"):
        getattr(lib, name).argtypes = [i64]
        getattr(lib, name).restype = i64
    lib.block_decode_points.argtypes = [p, p, i64, p, p, i64, p, p, p, i32,
                                        i32, i64, p, ctypes.c_uint32, p, p,
                                        p, p]
    lib.set_debug.argtypes = [p]
    return lib


def look_back_counts(words: np.ndarray) -> dict:
    rounds, lane, spins = words // 1000000, words // 1000 % 1000, words % 1000
    return {"rounds": np.bincount(rounds).tolist(),
            "nearest_inclusive_lane_median": float(np.median(lane)),
            "spins_median": float(np.median(spins)),
            "spins_p90": float(np.percentile(spins, 90))}


def profile(lib: ctypes.CDLL, label: str, points: int, dev) -> dict:
    args = decode_inputs(dev, points, seed=len(label))
    ts_nb, ts_pay, v_nb, v_pay, first, blk, base = args
    n = ts_nb.numel()
    state = torch.zeros(lib.block_decode_state_words(n), dtype=torch.int64,
                        device=dev)
    scratch = torch.empty(lib.block_decode_scratch_words(n),
                          dtype=torch.int32, device=dev)
    rel = torch.empty(n, dtype=torch.int32, device=dev)
    vals = torch.empty(n, dtype=torch.float32, device=dev)
    # Room for tiles of 256 points or more; the rows stamped are the tiles.
    stamps = torch.zeros((n // 256 + 1) * STAMPS, dtype=torch.int64,
                         device=dev)
    if lib.set_debug(stamps.data_ptr()) != 0:
        raise RuntimeError("set_debug failed")
    for tag in range(1, 5):  # the last call's stamps are kept
        rc = lib.block_decode_points(
            ts_nb.data_ptr(), ts_pay.data_ptr(), ts_pay.numel(),
            v_nb.data_ptr(), v_pay.data_ptr(), v_pay.numel(),
            first.data_ptr(), blk.data_ptr(), base.data_ptr(), 0, 0, n,
            state.data_ptr(), tag, scratch.data_ptr(), rel.data_ptr(),
            vals.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
    torch.cuda.synchronize()
    want = block_decode.decode_points_plain(*args, vkind="f32")
    if not (torch.equal(rel, want[0]) and torch.equal(
            vals.view(torch.int32), want[1].view(torch.int32))):
        raise RuntimeError(f"{label}: the instrumented kernel differs from "
                           "decode_points_plain")
    d = stamps.view(-1, STAMPS).cpu().numpy().astype(np.int64)
    d = d[d[:, 0] > 0]
    tiles = len(d)
    phases = np.diff(d[:, :9], axis=1) / 1e3
    events = sorted([(t, 1) for t in d[:, 0]] + [(t, -1) for t in d[:, 8]])
    live = peak = 0
    for _, step in events:
        live += step
        peak = max(peak, live)
    return {"gather": label, "points": points, "padded_points": n,
            "tiles": tiles, "most_tiles_in_flight": peak,
            "span_us": float(d[:, 8].max() - d[:, 0].min()) / 1e3,
            "tile_life_us": [float(np.median(d[:, 8] - d[:, 0])) / 1e3,
                             float(np.percentile(d[:, 8] - d[:, 0], 90))
                             / 1e3],
            "phase_us_median_p90": {
                name: [float(np.median(phases[:, k])),
                       float(np.percentile(phases[:, k], 90))]
                for k, name in enumerate(PHASES)},
            "offsets_look_back": look_back_counts(d[1:, 9]),
            "chains_look_back": look_back_counts(d[1:, 10])}


def main(argv: list[str]) -> int:
    if argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    with tempfile.TemporaryDirectory() as workdir:
        lib = build(workdir)
        for label, points in (("week-size gather", 10_000_400),
                              ("day-size gather", 1_500_000),
                              ("TSINT-week-size gather", 40_320)):
            print(json.dumps({**profile(lib, label, points, dev),
                              "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
