"""Segment reductions: the CUDA kernels of ``csrc/segment_reduce.cu`` and
their plain PyTorch versions.

``segment_sum`` is the port of the JAX package's one TPU kernel,
``opentsdb_tpu/ops/pallas_kernels.py`` ``pallas_segment_sum``: the
per-(series, bucket) and per-(group, bucket) reduction under every
downsampled query (``ops/kernels.py`` ``_segment_moments`` and
``_group_stage``). ``segment_minmax`` replaces the XLA
``segment_min``/``segment_max`` in the same two places and, like them,
computes only the output the caller asks for (``need=``). The source file
says how each kernel is built for Hopper, what bounds it and which of its
two designs (run merge for many segments, shared-memory privatisation for
few) a call takes.

Each wrapper takes its plain version only for tensors that lie on the CPU;
for CUDA tensors it launches its kernel on the calling thread's current
stream or raises. ``launches`` on each wrapper counts kernel launches (and
nothing else), so a run can show that its path went through the kernels.
Ids are int32 at these functions, as in the JAX package; ids outside
``[0, num_segments)`` drop out.
"""

from __future__ import annotations

import ctypes

import torch

from opentsdb_tpu_torch.ops import cuda_build

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("segment_reduce")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.segment_sum_f32.argtypes = [p, p, i64, i32, i64, p, p]
        lib.segment_sum_f32.restype = ctypes.c_int
        lib.segment_minmax_f32.argtypes = [p, p, i64, i32, i64, p, p, p]
        lib.segment_minmax_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(vals: torch.Tensor, seg: torch.Tensor, num_segments: int) -> None:
    if vals.dim() != 2 or vals.dtype != torch.float32:
        raise ValueError(f"values must be [N, K] float32, got "
                         f"{tuple(vals.shape)} {vals.dtype}")
    if seg.dim() != 1 or seg.dtype != torch.int32 \
            or seg.shape[0] != vals.shape[0]:
        raise ValueError(f"ids must be [N] int32 matching values, got "
                         f"{tuple(seg.shape)} {seg.dtype}")
    if seg.device != vals.device:
        raise ValueError(f"values on {vals.device}, ids on {seg.device}")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")


def _launch(fn, vals: torch.Tensor, seg: torch.Tensor, num_segments: int,
            *outs: torch.Tensor | None) -> None:
    """Launch ``fn`` on the current stream; an output passed as None is
    not computed (a null pointer to the kernel)."""
    if vals.device.type != "cuda":
        raise ValueError(f"no kernel for device {vals.device}")
    vals = vals.contiguous()
    seg = seg.contiguous()
    # The current stream's raw handle: torch.cuda.current_stream() builds
    # a Stream object first, ~4 us of host time per call, about what a
    # small kernel runs. The binding is private to PyTorch (checked
    # against torch 2.11); tests/test_torch_cuda.py exercises it.
    stream = torch._C._cuda_getCurrentRawStream(vals.device.index)
    with torch.cuda.device(vals.device):
        rc = fn(vals.data_ptr(), seg.data_ptr(), vals.shape[0],
                vals.shape[1], num_segments,
                *(None if o is None else o.data_ptr() for o in outs), stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def segment_sum_plain(feat: torch.Tensor, seg: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Plain PyTorch ``segment_sum``: masked ``index_add_``."""
    keep = (seg >= 0) & (seg < num_segments)
    out = torch.zeros((num_segments, feat.shape[1]), dtype=feat.dtype,
                      device=feat.device)
    return out.index_add_(0, seg[keep].long(), feat[keep])


def segment_sum(feat: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum [N, K] float32 features by [N] int32 segment ids into
    [num_segments, K]."""
    _check(feat, seg, num_segments)
    if feat.device.type == "cpu":
        return segment_sum_plain(feat, seg, num_segments)
    out = torch.zeros((num_segments, feat.shape[1]), dtype=torch.float32,
                      device=feat.device)
    _launch(_kernels().segment_sum_f32, feat, seg, num_segments, out)
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


_NEEDS = ("min", "max", "both")


def _check_need(need: str) -> None:
    if need not in _NEEDS:
        raise ValueError(f"need must be one of {_NEEDS}, got {need!r}")


def segment_minmax_plain(vals: torch.Tensor, seg: torch.Tensor,
                         num_segments: int, need: str = "both"):
    """Plain PyTorch ``segment_minmax``: masked ``scatter_reduce_``."""
    _check_need(need)
    keep = (seg >= 0) & (seg < num_segments)
    v = vals[keep]
    idx = seg[keep].long()[:, None].expand(-1, vals.shape[1])
    shape = (num_segments, vals.shape[1])
    mn = mx = None
    if need != "max":
        mn = torch.full(shape, float("inf"), dtype=vals.dtype,
                        device=vals.device).scatter_reduce_(0, idx, v, "amin")
    if need != "min":
        mx = torch.full(shape, float("-inf"), dtype=vals.dtype,
                        device=vals.device).scatter_reduce_(0, idx, v, "amax")
    return (mn, mx) if need == "both" else (mn if need == "min" else mx)


def segment_minmax(vals: torch.Tensor, seg: torch.Tensor,
                   num_segments: int, need: str = "both"):
    """Per-segment min and max of [N, K] float32 values by [N] int32 ids,
    each [num_segments, K]; +inf / -inf for a segment with no element.

    ``need`` is "min" or "max" for that one tensor alone (the other is not
    computed), or "both" for the pair (min, max)."""
    _check(vals, seg, num_segments)
    _check_need(need)
    if vals.device.type == "cpu":
        return segment_minmax_plain(vals, seg, num_segments, need)
    shape = (num_segments, vals.shape[1])
    mn = mx = None
    if need != "max":
        mn = torch.full(shape, float("inf"), dtype=torch.float32,
                        device=vals.device)
    if need != "min":
        mx = torch.full(shape, float("-inf"), dtype=torch.float32,
                        device=vals.device)
    _launch(_kernels().segment_minmax_f32, vals, seg, num_segments, mn, mx)
    segment_minmax.launches += 1
    return (mn, mx) if need == "both" else (mn if need == "min" else mx)


segment_minmax.launches = 0
