"""The rollup window fold: the CUDA kernel of ``csrc/rollup_fold.cu`` and
its plain PyTorch version.

The port of the JAX package's device checkpoint fold,
``opentsdb_tpu/rollup/summary.py`` ``_device_fold_fn`` / ``fold`` (an XLA
scatter fold behind ``window_summaries_device``, ``Config.
rollup_device_fold``): per window ``w = rel_ts // res`` of time-sorted
points, the count, sum, min, max, first and last values and the first and
last timestamps. The kernel computes in float64 (the JAX package's TPU
could only do float32), in a fixed order, so two calls give identical
bits; the source file says how.

- ``window_fold_batch(rel_ts, vals, offsets, *, res, num_windows)`` folds
  S series (segments ``offsets`` [S + 1] of the concatenated columns) at
  every resolution in one launch: ``(icol int32 [3, N], fcol float64
  [5, N])`` over the dense slot grid, slot ``slot0[i] + j * W_i + w`` for
  resolution i, series j, window w (``grid_slots`` gives ``slot0``).
  Nothing is synchronised; ``read_back`` brings both blocks to the host
  in one copy and raises there if any series was unsorted. The tier's
  group fold (``rollup/summary.group_summaries_device``) calls the two.
- ``window_fold(rel_ts, vals, *, num_windows, res)`` is its one-series,
  one-resolution case: the eight per-window tensors of the JAX ``fold``
  (count int32, sum, min, max, first, last float64, t_first and t_last
  int32), views of one buffer, so ``to_numpy`` brings them to the host in
  one copy. Empty windows carry count 0 (and min +inf, max -inf, zeros
  elsewhere).
- ``window_fold_batch_plain`` / ``window_fold_plain`` are the plain
  PyTorch versions. They reproduce the kernel's order of
  addition -- per lane of a window, a sequential sum over points lo + l,
  lo + l + 32, ...; then the xor butterfly over the 32 lanes -- so they
  agree with the kernel bit for bit.

Timestamps must be sorted ascending within each series; the wrappers
raise on unsorted input. They take the plain version only for CPU
tensors; on a CUDA tensor they launch the kernel or raise.
``window_fold.launches`` counts kernel launches of both entries, and
nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from opentsdb_tpu_torch.ops import cuda_build

MAX_RES = 8         # the kernel's kMaxRes
_LANES = 32

_lib = None


class _FoldGrid(ctypes.Structure):
    """``FoldGrid`` of ``csrc/rollup_fold.cu``."""
    _fields_ = [("nres", ctypes.c_int32),
                ("res", ctypes.c_int32 * MAX_RES),
                ("windows", ctypes.c_int32 * MAX_RES),
                ("slot0", ctypes.c_int64 * (MAX_RES + 1))]


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("rollup_fold")
        p = ctypes.c_void_p
        lib.rollup_window_fold_f64.argtypes = [
            p, p, p, ctypes.POINTER(_FoldGrid), p, p, p]
        lib.rollup_window_fold_f64.restype = ctypes.c_int
        _lib = lib
    return _lib


def grid_slots(num_series: int, num_windows: Sequence[int]) -> list[int]:
    """``slot0``: the first slot of each resolution, then the grid's
    size."""
    out = [0]
    for W in num_windows:
        out.append(out[-1] + num_series * int(W))
    return out


def _check(rel_ts: torch.Tensor, vals: torch.Tensor, offsets: torch.Tensor,
           res: Sequence[int], num_windows: Sequence[int]) -> None:
    if rel_ts.dim() != 1 or rel_ts.dtype != torch.int32:
        raise ValueError(f"rel_ts must be [n] int32, got "
                         f"{tuple(rel_ts.shape)} {rel_ts.dtype}")
    if vals.dim() != 1 or vals.dtype != torch.float64 \
            or vals.shape[0] != rel_ts.shape[0]:
        raise ValueError(f"vals must be [n] float64 matching rel_ts, got "
                         f"{tuple(vals.shape)} {vals.dtype}")
    if offsets.dim() != 1 or offsets.dtype != torch.int64 \
            or offsets.shape[0] < 1:
        raise ValueError(f"offsets must be [S + 1] int64, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    if not vals.device == rel_ts.device == offsets.device:
        raise ValueError(f"rel_ts on {rel_ts.device}, vals on "
                         f"{vals.device}, offsets on {offsets.device}")
    if not 1 <= len(res) == len(num_windows) <= MAX_RES:
        raise ValueError(f"1 to {MAX_RES} resolutions, one window count "
                         f"each: {tuple(res)}, {tuple(num_windows)}")
    for W, r in zip(num_windows, res):
        if not 0 < W < 2**31 or not 0 < r < 2**31:
            raise ValueError(f"num_windows {W} and res {r} must be "
                             f"positive int32")
    if rel_ts.shape[0] >= 2**31:
        raise ValueError("the kernel counts points in int32")


def _buffers(N: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(icol int32 [3, N], fcol float64 [5, N]): the two output blocks
    as views of one float64 buffer, fcol first."""
    buf = torch.empty(5 * N + (3 * N + 1) // 2, dtype=torch.float64,
                      device=device)
    fcol = buf[:5 * N].view(5, N)
    icol = buf[5 * N:].view(torch.int32)[:3 * N].view(3, N)
    return icol, fcol


def _fold_plain(rel_ts: torch.Tensor, vals: torch.Tensor,
                offsets: torch.Tensor, res: Sequence[int],
                num_windows: Sequence[int],
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(icol, fcol) of the kernel's slot grid, in the kernel's order of
    addition: each point's slot from its clipped window id (sorted input
    keeps a series' windows contiguous, so a slot's points are a run
    [lo, hi)); point lo + l + 32 k adds to lane l's sum in step k, one
    add per (slot, lane) a step; then the xor butterfly. min and max are
    order-free (scatter_reduce amin / amax propagate NaN as numpy does).
    Out-of-order input marks slot 0's count -1, as the kernel marks the
    slots that see it."""
    dev = rel_ts.device
    S = offsets.shape[0] - 1
    n = rel_ts.shape[0]
    slot0 = grid_slots(S, num_windows)
    N = slot0[-1]
    icol, fcol = _buffers(N, dev)
    icol.zero_()
    fcol.zero_()
    fcol[1] = float("inf")
    fcol[2] = float("-inf")
    if n == 0 or N == 0:
        return icol, fcol
    sizes = offsets[1:] - offsets[:-1]
    if bool((sizes < 0).any()) or int(offsets[-1]) != n \
            or int(offsets[0]) != 0:
        raise ValueError("offsets must rise from 0 to len(rel_ts)")
    sid = torch.repeat_interleave(torch.arange(S, device=dev), sizes)
    if bool(((rel_ts[1:] < rel_ts[:-1]) & (sid[1:] == sid[:-1])).any()):
        icol[0, 0] = -1
        return icol, fcol
    lanes = torch.arange(_LANES, device=dev)
    for i, (r, W) in enumerate(zip(res, num_windows)):
        w = torch.clamp(torch.div(rel_ts.long(), r, rounding_mode="floor"),
                        0, W - 1)
        slot = sid * W + w          # the slot within resolution i
        cnt = torch.bincount(slot, minlength=S * W)
        ends = torch.cumsum(cnt, 0)
        starts = ends - cnt
        pos = torch.arange(n, device=dev) - starts[slot]
        target = slot * _LANES + pos % _LANES
        step = pos // _LANES
        order = torch.argsort(step, stable=True)
        per_step = torch.bincount(step, minlength=1).tolist()
        acc = torch.zeros(S * W * _LANES, dtype=torch.float64,
                          device=dev)
        a = 0
        for c in per_step:
            idx = order[a:a + c]
            t = target[idx]
            acc[t] = acc[t] + vals[idx]
            a += c
        acc = acc.view(S * W, _LANES)
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[:, lanes ^ off]
        lo, hi = slot0[i], slot0[i + 1]
        icol[0, lo:hi] = cnt.to(torch.int32)
        fcol[0, lo:hi] = acc[:, 0]
        fcol[1, lo:hi].scatter_reduce_(0, slot, vals, "amin")
        fcol[2, lo:hi].scatter_reduce_(0, slot, vals, "amax")
        some = cnt > 0
        first = starts[some]
        last = ends[some] - 1
        icol[1, lo:hi][some] = rel_ts[first]
        icol[2, lo:hi][some] = rel_ts[last]
        fcol[3, lo:hi][some] = vals[first]
        fcol[4, lo:hi][some] = vals[last]
    return icol, fcol


def _fold_launch(rel_ts: torch.Tensor, vals: torch.Tensor,
                 offsets: torch.Tensor, res: Sequence[int],
                 num_windows: Sequence[int],
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's (icol, fcol) for CUDA tensors, enqueued on the current
    stream; no synchronisation."""
    if rel_ts.device.type != "cuda":
        raise ValueError(f"no kernel for device {rel_ts.device}")
    dev = rel_ts.device
    lib = _kernels()
    rel_ts, vals = rel_ts.contiguous(), vals.contiguous()
    offsets = offsets.contiguous()
    slot0 = grid_slots(offsets.shape[0] - 1, num_windows)
    grid = _FoldGrid(len(res))
    for i, (r, W) in enumerate(zip(res, num_windows)):
        grid.res[i], grid.windows[i] = int(r), int(W)
    for i, s in enumerate(slot0):
        grid.slot0[i] = s
    icol, fcol = _buffers(slot0[-1], dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = (rel_ts.data_ptr(), vals.data_ptr(), offsets.data_ptr(),
            ctypes.byref(grid), icol.data_ptr(), fcol.data_ptr(), stream)
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


def window_fold_batch_plain(rel_ts: torch.Tensor, vals: torch.Tensor,
                            offsets: torch.Tensor, *, res: Sequence[int],
                            num_windows: Sequence[int],
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ``window_fold_batch``."""
    _check(rel_ts, vals, offsets, res, num_windows)
    return _fold_plain(rel_ts, vals, offsets, res, num_windows)


def window_fold_batch(rel_ts: torch.Tensor, vals: torch.Tensor,
                      offsets: torch.Tensor, *, res: Sequence[int],
                      num_windows: Sequence[int],
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(icol int32 [3, N], fcol float64 [5, N]) of the slot grid of S
    series (``offsets`` [S + 1] into ``rel_ts`` [n] int32 / ``vals`` [n]
    float64, each series sorted ascending) at each resolution ``res[i]``
    with ``num_windows[i]`` windows: one launch, no synchronisation.
    Unsorted input marks counts -1, which ``read_back`` raises on."""
    _check(rel_ts, vals, offsets, res, num_windows)
    if rel_ts.device.type == "cpu":
        return _fold_plain(rel_ts, vals, offsets, res, num_windows)
    return _fold_launch(rel_ts, vals, offsets, res, num_windows)


_NUMPY = {torch.int32: np.int32, torch.float64: np.float64}


def to_numpy(out: Sequence[torch.Tensor]) -> list[np.ndarray]:
    """Tensors that are views of one buffer (``window_fold``'s eight, or
    ``window_fold_batch``'s two) as (read-only) numpy arrays of their
    shapes, from one copy of the buffer (no copy for CPU tensors)."""
    host = torch.empty(0, dtype=torch.uint8).set_(
        out[0].untyped_storage().cpu()).numpy()
    return [np.frombuffer(host, _NUMPY[x.dtype], x.numel(),
                          x.storage_offset() * x.element_size())
            .reshape(x.shape) for x in out]


def read_back(icol: torch.Tensor, fcol: torch.Tensor,
              ) -> tuple[np.ndarray, np.ndarray]:
    """``window_fold_batch``'s blocks on the host, in one copy (a sync on
    the card); raises if any slot saw unsorted input."""
    icol_np, fcol_np = to_numpy((icol, fcol))
    if icol_np.shape[1] and (icol_np[0] < 0).any():
        raise ValueError("window_fold needs rel_ts sorted ascending")
    return icol_np, fcol_np


def _one_series(rel_ts: torch.Tensor, num_windows: int, res: int) -> tuple:
    offsets = torch.tensor([0, rel_ts.shape[0]], dtype=torch.int64,
                           device=rel_ts.device)
    return offsets, (res,), (num_windows,)


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
    offsets, r, W = _one_series(rel_ts, num_windows, res)
    return _split(*window_fold_batch_plain(rel_ts, vals, offsets, res=r,
                                           num_windows=W))


def window_fold(rel_ts: torch.Tensor, vals: torch.Tensor, *,
                num_windows: int, res: int) -> tuple:
    """(count int32, sum, min, max, first, last float64, t_first,
    t_last int32), each [num_windows], of time-sorted points ``rel_ts``
    [n] int32 / ``vals`` [n] float64 in windows of ``res`` seconds:
    ``window_fold_batch`` with one series and one resolution. Raises on
    unsorted input (which reads the counts back: a sync)."""
    offsets, r, W = _one_series(rel_ts, num_windows, res)
    return _split(*window_fold_batch(rel_ts, vals, offsets, res=r,
                                     num_windows=W))


window_fold.launches = 0
