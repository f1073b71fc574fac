"""Attribute the time of the first rank-select and interpolate-and-reduce
kernels on one NVIDIA card: build their sources again with one part cut
out at a time and time each variant at the query paths' shapes.

    git archive 2a6ddd9 | tar -x -C DIR    # the sources before the redesign
    python -m opentsdb_tpu_torch.tools.attribute_kernels DIR

The variants are made by patching DIR's ``masked_select.cu`` and
``interp_moments.cu`` (the patches assert that the code they cut is there,
so the tool refuses other revisions) into ``DIR/_attribute/``:
- ``masked_select``: no count pass (every row counted valid, so its ranks
  are not the real ones); 0, 1 or 2 digit passes instead of 4; one
  selection per quantile instead of two; the cluster width forced to 1,
  2, 4, 8 or 16;
- ``interp_moments``: no merge walk; the binary searches replaced by a
  table of the tile starts' positions computed beforehand; a fast
  division; all three.
The variants compute wrong answers; only the committed sources are
checked against their plain versions. Also printed: ``nvcc -Xptxas -v``
of both sources and ``cudaOccupancyMaxActiveClusters`` of ``select_large``
for clusters of 1 to 16 blocks. Cases and timing are those of
``compare_kernels`` (device ms, median of 3 runs of 20 queued calls).
One JSON line per case on standard output, after the card's name and
power limit.

    python -m opentsdb_tpu_torch.tools.attribute_kernels --sketches DIR

does the same for DIR's ``sketches.cu`` t-digest fold as redesigned for
Hopper (the fold cases of ``compare_kernels --kernels sketches``):
1 or 2 radix passes instead of 4; the block returning right after its
sort; the cluster sums left out.
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
from opentsdb_tpu_torch.tools import compare_kernels as ck

SELECT_VARIANTS = {
    "base": [], "no_count": ["-DATTR_NO_COUNT"],
    "passes_0": ["-DATTR_PASSES=0"], "passes_1": ["-DATTR_PASSES=1"],
    "passes_2": ["-DATTR_PASSES=2"],
    "no_count_passes_0": ["-DATTR_NO_COUNT", "-DATTR_PASSES=0"],
    "floor_only": ["-DATTR_FLOOR_ONLY"],
    **{f"cluster_{c}": [f"-DATTR_FORCE_C={c}"] for c in (1, 2, 4, 8, 16)}}
INTERP_VARIANTS = {
    "base": [], "no_walk": ["-DATTR_NO_WALK"], "pos_table": ["-DATTR_POS"],
    "no_walk_pos_table": ["-DATTR_NO_WALK", "-DATTR_POS"],
    "fast_div": ["-DATTR_NO_DIV"],
    "all_three": ["-DATTR_NO_WALK", "-DATTR_POS", "-DATTR_NO_DIV"]}

_CLUSTERS = """
#define ATTR_CASE(n) case n: f = (const void*)select_large<n>; break;
extern "C" int attr_clusters(int C, int smem, int* out) {
  const void* f = nullptr;
  switch (C) {
    ATTR_CASE(1) ATTR_CASE(2) ATTR_CASE(3) ATTR_CASE(4) ATTR_CASE(5)
    ATTR_CASE(6) ATTR_CASE(7) ATTR_CASE(8) ATTR_CASE(9) ATTR_CASE(10)
    ATTR_CASE(11) ATTR_CASE(12) ATTR_CASE(13) ATTR_CASE(14) ATTR_CASE(15)
    ATTR_CASE(16)
    default: return -1;
  }
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && C > 8) {
    e = cudaFuncSetAttribute(
        f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(out, f, &cfg);
  cudaGetLastError();
  return (int)e;
}
"""


SKETCH_VARIANTS = {
    "base": [], "passes_1": ["-DATTR_FOLD_PASSES=1"],
    "passes_2": ["-DATTR_FOLD_PASSES=2"], "sort_only": ["-DATTR_SORT_ONLY"],
    "no_sums": ["-DATTR_NO_SUMS"]}


def _patch(src: str, edits: list[tuple[str, str]]) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"not the expected source: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def select_source(src: str) -> str:
    return _patch(src, [
        ("#include <atomic>\n",
         "#include <atomic>\n#ifndef ATTR_PASSES\n#define ATTR_PASSES 4\n"
         "#endif\n"),
        ("  uint32_t cnt = 0;\n  if (live) {",
         "  uint32_t cnt = 0;\n#ifdef ATTR_NO_COUNT\n"
         "  if (rank == 0 && warp == 0) cnt = (uint32_t)(r1 - r0);\n"
         "  if (false) {\n#else\n  if (live) {\n#endif"),
        ("  const int nsel = 2 * qs.k;",
         "#ifdef ATTR_FLOOR_ONLY\n  const int nsel = qs.k;\n#else\n"
         "  const int nsel = 2 * qs.k;\n#endif"),
        ("shift >= 0; shift -= 8)",
         "shift >= 32 - 8 * ATTR_PASSES; shift -= 8)"),
        ("  for (int32_t q0 = 0; q0 < k; q0 += kMaxQ) {",
         "#ifdef ATTR_FORCE_C\n  C = ATTR_FORCE_C;\n#endif\n"
         "  for (int32_t q0 = 0; q0 < k; q0 += kMaxQ) {"),
    ]) + _CLUSTERS


def interp_source(src: str) -> str:
    return _patch(src, [
        ("constexpr int kThreads = 256;",
         "constexpr int kThreads = 256;\n__device__ const int32_t* g_pos;"),
        ("        int a = 0, b = n;\n        while (a < b) {",
         "        int a = 0, b = n;\n#ifdef ATTR_POS\n"
         "        a = g_pos[(int64_t)blockIdx.x * S + s];\n        b = a;\n"
         "#endif\n        while (a < b) {"),
        ("        if (pos < n && x1 <= x) {",
         "#ifdef ATTR_NO_WALK\n        if (false) {\n#else\n"
         "        if (pos < n && x1 <= x) {\n#endif"),
        ("          const float t = __fdiv_rn((float)(x - x0), dx);",
         "#ifdef ATTR_NO_DIV\n"
         "          const float t = __fdividef((float)(x - x0), dx);\n"
         "#else\n"
         "          const float t = __fdiv_rn((float)(x - x0), dx);\n#endif"),
    ]) + """
extern "C" int attr_set_pos(const int32_t* p) {
  return (int)cudaMemcpyToSymbol(g_pos, &p, sizeof(p));
}
"""


def sketch_source(src: str) -> str:
    return _patch(src, [
        ("constexpr int kPasses = 4;\n",
         "constexpr int kPasses = 4;\n#ifndef ATTR_FOLD_PASSES\n"
         "#define ATTR_FOLD_PASSES 4\n#endif\n"),
        ("pass < kPasses; ++pass) {\n    const int shift = 8 * pass;\n"
         "    for (int j = lane;",
         "pass < ATTR_FOLD_PASSES; ++pass) {\n"
         "    const int shift = 8 * pass;\n    for (int j = lane;"),
        ("  // The m live entries in sorted order",
         "#ifdef ATTR_SORT_ONLY\n  return;\n#endif\n"
         "  // The m live entries in sorted order"),
        ("  for (int c = threadIdx.x; c < K; c += blockDim.x) {\n"
         "    float ws = 0.0f, ms = 0.0f;\n    for (int i = first[c];",
         "#ifdef ATTR_NO_SUMS\n  return;\n#endif\n"
         "  for (int c = threadIdx.x; c < K; c += blockDim.x) {\n"
         "    float ws = 0.0f, ms = 0.0f;\n    for (int i = first[c];"),
    ])


def sketch_main(root: str, smi: str) -> int:
    csrc = os.path.join(root, "opentsdb_tpu_torch", "csrc")
    out_dir = os.path.join(root, "_attribute")
    os.makedirs(out_dir, exist_ok=True)
    print(json.dumps({"ptxas": "sketches", "lines": ptxas(
        os.path.join(csrc, "sketches.cu"))}), flush=True)
    with open(os.path.join(csrc, "sketches.cu")) as f:
        libs = build(out_dir, "sketches", sketch_source(f.read()),
                     SKETCH_VARIANTS)
    _, vals = ck.corpus()
    for case in ck.sketch_cases(torch.device("cuda"), vals)[:2]:
        case.fill()
        case.call(libs["base"])
        torch.cuda.synchronize()
        err = case.check()
        row = {}
        for name, lib in libs.items():
            case.fill()
            row[name] = timed(lambda lib=lib: case.call(lib))
        print(json.dumps({"kernel": case.kernel, "case": case.label,
                          **case.info, "max_abs_err": err,
                          "device_ms": row, "card": smi}), flush=True)
    return 0


def ptxas(path: str) -> list[str]:
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                        os.devnull, path], capture_output=True, text=True)
    return [line.strip() for line in (r.stdout + r.stderr).splitlines()
            if "registers" in line or "spill" in line or "entry" in line]


def build(out_dir: str, kernel: str, src: str, variants: dict) -> dict:
    path = os.path.join(out_dir, f"{kernel}.cu")
    with open(path, "w") as f:
        f.write(src)
    jobs = {name: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, *flags, "-o",
         os.path.join(out_dir, f"{kernel}_{name}.so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for name, flags in variants.items()}
    libs = {}
    for name, proc in jobs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel} {name}:\n{log}")
        libs[name] = ck.bind(ctypes.CDLL(os.path.abspath(
            os.path.join(out_dir, f"{kernel}_{name}.so"))), kernel)
    return libs


def timed(fn) -> float:
    return float(np.median([ck.device_ms(fn) for _ in range(3)]))


def main(argv: list[str]) -> int:
    sk = argv[:1] == ["--sketches"]
    if len(argv) != 1 + sk or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if sk:
        return sketch_main(argv[1], smi)
    csrc = os.path.join(argv[0], "opentsdb_tpu_torch", "csrc")
    out_dir = os.path.join(argv[0], "_attribute")
    os.makedirs(out_dir, exist_ok=True)
    for k in ("masked_select", "interp_moments"):
        print(json.dumps({"ptxas": k, "lines": ptxas(
            os.path.join(csrc, k + ".cu"))}), flush=True)
    with open(os.path.join(csrc, "masked_select.cu")) as f:
        sel = build(out_dir, "masked_select", select_source(f.read()),
                    SELECT_VARIANTS)
    with open(os.path.join(csrc, "interp_moments.cu")) as f:
        itp = build(out_dir, "interp_moments", interp_source(f.read()),
                    INTERP_VARIANTS)
    probe = sel["base"].attr_clusters
    probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for nsel in (2, 6):       # one and three quantiles, two ranks each
        smem = nsel * 256 * 33 * 4
        got = {}
        for c in range(1, 17):
            n = ctypes.c_int(0)
            rc = probe(c, smem, ctypes.byref(n))
            got[c] = n.value if rc == 0 else f"error {rc}"
        print(json.dumps({"max_active_clusters": got, "smem": smem,
                          "threads": 512}), flush=True)
    dev = torch.device("cuda")
    ts, vals = ck.corpus()
    for case in ck.select_cases(dev, ts, vals):
        case.call(sel["base"])
        torch.cuda.synchronize()
        err = case.check()
        row = {name: timed(lambda lib=lib: case.call(lib))
               for name, lib in sel.items()}
        print(json.dumps({"kernel": case.kernel, "case": case.label,
                          **case.info, "max_abs_err": err,
                          "device_ms": row, "card": smi}), flush=True)
    for case, (rows, end) in zip(ck.interp_cases(dev, ts, vals), (
            (np.arange(0, ck.SERIES, 10), ck.BASE + ck.DAY - 1),
            (np.arange(ck.SERIES), ck.BASE + ck.SPAN - 1))):
        # Each 256-point tile's start, placed in every series beforehand.
        t, grid = ck.union_inputs(dev, ts, vals, rows, end)
        idx = torch.arange(t[0].shape[1], device=dev)
        safe = torch.where(idx[None, :] < t[2][:, None], t[0], 2**31 - 1)
        starts = grid[::256].contiguous()
        pos = torch.searchsorted(
            safe.contiguous(), starts[None, :].expand(len(rows), -1)
            .contiguous(), right=True, out_int32=True).t().contiguous()
        case.call(itp["base"])
        torch.cuda.synchronize()
        err = case.check()
        row = {}
        for name, lib in itp.items():
            if "-DATTR_POS" in INTERP_VARIANTS[name]:
                lib.attr_set_pos.argtypes = [ctypes.c_void_p]
                if lib.attr_set_pos(pos.data_ptr()) != 0:
                    raise RuntimeError("cudaMemcpyToSymbol failed")
            row[name] = timed(lambda lib=lib: case.call(lib))
        print(json.dumps({"kernel": case.kernel, "case": case.label,
                          **case.info, "max_abs_err": err,
                          "device_ms": row, "card": smi}), flush=True)
        del t, grid, safe, pos
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
