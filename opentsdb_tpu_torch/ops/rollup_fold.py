"""The rollup window fold: the CUDA kernel of ``csrc/rollup_fold.cu`` and
its plain PyTorch version.

The port of the JAX package's device checkpoint fold,
``opentsdb_tpu/rollup/summary.py`` ``_device_fold_fn`` / ``fold`` (an XLA
scatter fold behind ``window_summaries_device``, ``Config.
rollup_device_fold``): per window ``w = rel_ts // res`` of one series'
time-sorted points, the count, sum, min, max, first and last values and
the first and last timestamps. The kernel computes in float64 (the JAX
package's TPU could only do float32), in a fixed order, so two calls give
identical bits; the source file says how.

- ``window_fold(rel_ts, vals, *, num_windows, res)`` returns the eight
  per-window tensors of the JAX ``fold``: count int32, sum, min, max,
  first, last float64, t_first and t_last int32 (rel_ts values). Empty
  windows carry count 0 (and min +inf, max -inf, zeros elsewhere). The
  eight are views of one buffer, so ``to_numpy`` brings them to the host
  in one copy; ``rollup/summary.window_summaries_device``, the tier's
  checkpoint fold, calls the two.
- ``window_fold_plain`` is the plain PyTorch version (CPU tensors).

Timestamps must be sorted ascending; ``window_fold`` raises on unsorted
input. It takes the plain version only for CPU tensors; on a CUDA tensor
it launches the kernel or raises. ``window_fold.launches`` counts kernel
launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opentsdb_tpu_torch.ops import cuda_build

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("rollup_fold")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.rollup_window_fold_f64.argtypes = [p, p, i64, i32, i32, p, p,
                                               p]
        lib.rollup_window_fold_f64.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(rel_ts: torch.Tensor, vals: torch.Tensor, num_windows: int,
           res: int) -> None:
    if rel_ts.dim() != 1 or rel_ts.dtype != torch.int32:
        raise ValueError(f"rel_ts must be [n] int32, got "
                         f"{tuple(rel_ts.shape)} {rel_ts.dtype}")
    if vals.dim() != 1 or vals.dtype != torch.float64 \
            or vals.shape[0] != rel_ts.shape[0]:
        raise ValueError(f"vals must be [n] float64 matching rel_ts, got "
                         f"{tuple(vals.shape)} {vals.dtype}")
    if vals.device != rel_ts.device:
        raise ValueError(f"rel_ts on {rel_ts.device}, vals on {vals.device}")
    if not 0 < num_windows < 2**31 or not 0 < res < 2**31:
        raise ValueError(f"num_windows {num_windows} and res {res} must "
                         f"be positive int32")
    if rel_ts.shape[0] >= 2**31:
        raise ValueError("the kernel counts points in int32")


def _buffers(num_windows: int, device,
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(icol int32 [3, W], fcol float64 [5, W]): the two output blocks
    as views of one float64 buffer, fcol first."""
    W = num_windows
    buf = torch.empty(5 * W + (3 * W + 1) // 2, dtype=torch.float64,
                      device=device)
    fcol = buf[:5 * W].view(5, W)
    icol = buf[5 * W:].view(torch.int32)[:3 * W].view(3, W)
    return icol, fcol


def _fold_plain(rel_ts: torch.Tensor, vals: torch.Tensor, num_windows: int,
                res: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(icol int32 [3, W], fcol float64 [5, W]) by scatter reductions:
    the JAX fold's clipped window ids, then index_add_ and scatter_reduce
    (amin / amax propagate NaN as numpy does). Out-of-order input marks
    window 0's count -1, as the kernel marks the windows that see it."""
    W = num_windows
    n = rel_ts.shape[0]
    icol, fcol = _buffers(W, rel_ts.device)
    icol.zero_()
    fcol.zero_()
    fcol[1] = float("inf")
    fcol[2] = float("-inf")
    if n == 0:
        return icol, fcol
    if bool((rel_ts[1:] < rel_ts[:-1]).any()):
        icol[0, 0] = -1
        return icol, fcol
    w = torch.clamp(torch.div(rel_ts.long(), res, rounding_mode="floor"),
                    0, W - 1)
    icol[0] = torch.bincount(w, minlength=W).to(torch.int32)
    fcol[0].index_add_(0, w, vals)
    fcol[1].scatter_reduce_(0, w, vals, "amin")
    fcol[2].scatter_reduce_(0, w, vals, "amax")
    # Sorted input: a window's points are contiguous, so its first and
    # last are the ends of its run.
    ends = torch.cumsum(icol[0].long(), 0)
    starts = ends - icol[0].long()
    some = icol[0] > 0
    first = starts[some]
    last = ends[some] - 1
    icol[1, some] = rel_ts[first]
    icol[2, some] = rel_ts[last]
    fcol[3, some] = vals[first]
    fcol[4, some] = vals[last]
    return icol, fcol


def _fold_launch(rel_ts: torch.Tensor, vals: torch.Tensor, num_windows: int,
                 res: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's (icol, fcol) for CUDA tensors, enqueued on the current
    stream; no synchronisation."""
    if rel_ts.device.type != "cuda":
        raise ValueError(f"no kernel for device {rel_ts.device}")
    dev = rel_ts.device
    lib = _kernels()
    rel_ts, vals = rel_ts.contiguous(), vals.contiguous()
    icol, fcol = _buffers(num_windows, dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = (rel_ts.data_ptr(), vals.data_ptr(), rel_ts.shape[0],
            num_windows, res, icol.data_ptr(), fcol.data_ptr(), stream)
    if dev.index == torch._C._cuda_getDevice():
        rc = lib.rollup_window_fold_f64(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.rollup_window_fold_f64(*args)
    if rc != 0:
        raise RuntimeError(
            f"rollup_window_fold_f64 launch failed: CUDA error {rc}")
    window_fold.launches += 1
    return icol, fcol


def _split(icol: torch.Tensor, fcol: torch.Tensor) -> tuple:
    count, t_first, t_last = icol.unbind(0)
    # On the card this reads the count row back: a copy and a sync.
    if (count.cpu().numpy() < 0).any():
        raise ValueError("window_fold needs rel_ts sorted ascending")
    return (count, *fcol.unbind(0), t_first, t_last)


def window_fold_plain(rel_ts: torch.Tensor, vals: torch.Tensor, *,
                      num_windows: int, res: int) -> tuple:
    """Plain PyTorch ``window_fold``: (count, sum, min, max, first, last,
    t_first, t_last) per window."""
    _check(rel_ts, vals, num_windows, res)
    return _split(*_fold_plain(rel_ts, vals, num_windows, res))


def window_fold(rel_ts: torch.Tensor, vals: torch.Tensor, *,
                num_windows: int, res: int) -> tuple:
    """(count int32, sum, min, max, first, last float64, t_first,
    t_last int32), each [num_windows], of time-sorted points ``rel_ts``
    [n] int32 / ``vals`` [n] float64 in windows of ``res`` seconds.
    Raises on unsorted input (which reads the counts back: a sync)."""
    _check(rel_ts, vals, num_windows, res)
    if rel_ts.device.type == "cpu":
        return _split(*_fold_plain(rel_ts, vals, num_windows, res))
    return _split(*_fold_launch(rel_ts, vals, num_windows, res))


window_fold.launches = 0


_NUMPY = {torch.int32: np.int32, torch.float64: np.float64}


def to_numpy(out: tuple) -> list[np.ndarray]:
    """``window_fold``'s eight tensors as (read-only) numpy arrays, from
    one copy of the buffer they share (no copy for CPU tensors)."""
    host = torch.empty(0, dtype=torch.uint8).set_(
        out[0].untyped_storage().cpu()).numpy()
    return [np.frombuffer(host, _NUMPY[x.dtype], x.numel(),
                          x.storage_offset() * x.element_size())
            for x in out]
