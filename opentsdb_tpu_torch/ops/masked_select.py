"""Masked rank selection: the CUDA kernel of ``csrc/masked_select.cu`` and
its plain PyTorch version.

Per column of a [S, B] float32 grid with a [S, B] validity mask, the
linear-interpolated quantiles across the valid rows, as numpy's default
``quantile``: position (n - 1) * q in float32 between the values of rank
floor and ceil of it; a column with no valid entry gives 0. Two entry
points:

- ``select_columns`` (all rows one group) replaces the JAX package's
  ``masked_quantile_axis0`` (``opentsdb_tpu/ops/kernels.py:818``), [K, B];
- ``select_groups`` replaces its ``masked_quantile_groups`` (``:878``),
  [K, G, B], over a ``GroupLayout``: the rows sorted by group and each
  group's offsets, built once per group map (``group_layout``).

Each wrapper takes its plain version only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel on the calling thread's current
stream or raises. ``launches`` on each wrapper counts kernel launches (one
per call, whatever the number of quantiles) and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from opentsdb_tpu_torch.ops import cuda_build

# Groups of at most this many rows are selected in registers, the others
# by the radix select (kSmall in csrc/masked_select.cu).
SMALL_ROWS = 32
_INVALID = 0xFFFFFFFF

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("masked_select")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.masked_select_columns.argtypes = [p, p, i64, i64, p, i32, p, p]
        lib.masked_select_columns.restype = ctypes.c_int
        lib.masked_select_groups.argtypes = [p, p, i64, i64, p, p, i64, p,
                                             i64, p, i32, p, p]
        lib.masked_select_groups.restype = ctypes.c_int
        lib.masked_select_plan.argtypes = [i64, i64, i64, i32, p]
        lib.masked_select_plan.restype = ctypes.c_int
        _lib = lib
    return _lib


class GroupLayout(NamedTuple):
    """Rows grouped for ``select_groups``: group g's rows are
    ``order[offsets[g]:offsets[g + 1]]``; ``big`` lists the groups of more
    than SMALL_ROWS rows. All int32, on the grid's device."""
    order: torch.Tensor
    offsets: torch.Tensor
    big: torch.Tensor


def group_layout(gmap, num_groups: int,
                 device: torch.device | str | None = None) -> GroupLayout:
    """The layout of a [S] group map (numpy or tensor, every entry in
    [0, num_groups)), built on the host: a tensor map on the card is
    copied back first."""
    if isinstance(gmap, torch.Tensor):
        device = gmap.device if device is None else device
        gmap = gmap.cpu().numpy()
    gmap = np.asarray(gmap)
    if gmap.size and (gmap.min() < 0 or gmap.max() >= num_groups):
        raise ValueError(f"group ids must lie in [0, {num_groups})")
    order = np.argsort(gmap, kind="stable").astype(np.int32)
    sizes = np.bincount(gmap, minlength=num_groups)
    offsets = np.zeros(num_groups + 1, np.int32)
    np.cumsum(sizes, out=offsets[1:])
    big = np.flatnonzero(sizes > SMALL_ROWS).astype(np.int32)
    return GroupLayout(*(torch.from_numpy(x).to(device)
                         for x in (order, offsets, big)))


def launch_plan(S: int, B: int, n_big: int, k: int) -> dict:
    """How the kernel runs its large groups (the columns entry: one group
    of S rows; the grouped entry: ``n_big`` groups of more than SMALL_ROWS
    rows, S rows in all) for the first chunk of ``k`` quantiles on the
    current CUDA device: the cluster width, how many such clusters the card
    runs at once at the launch's shared memory, the rows a block stages in
    shared memory (a larger share is counted from device memory), whether
    the counters are 32-bit and the dynamic shared memory in bytes."""
    out = (ctypes.c_int32 * 5)()
    rc = _kernels().masked_select_plan(S, B, n_big, k, out)
    if rc != 0:
        raise RuntimeError(f"masked_select_plan failed: CUDA error {rc}")
    return {"cluster": out[0], "coresident_clusters": out[1],
            "stage_rows": out[2], "wide_counters": bool(out[3]),
            "smem_bytes": out[4]}


def order_key(vals: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_order_key`` (IEEE total order, f32 -> uint32)
    as int64 values in [0, 2^32): torch has no unsigned 32-bit shifts or
    compares on CUDA."""
    b = vals.contiguous().view(torch.int32).to(torch.int64) & _INVALID
    return torch.where(b >= 2**31, b ^ _INVALID, b | 2**31)


def key_to_float(key: torch.Tensor) -> torch.Tensor:
    """Inverse of ``order_key``."""
    b = torch.where(key < 2**31, key ^ _INVALID, key & 0x7FFFFFFF)
    return torch.where(b >= 2**31, b - 2**32, b).to(torch.int32) \
        .view(torch.float32)


def _q_list(q) -> list[float]:
    """Quantiles as float32-rounded Python floats (the kernel's type)."""
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(q, np.float32)).tolist()


def _lerp_ranks(sorted_keys: torch.Tensor, starts: torch.Tensor,
                n: torch.Tensor, q: list[float]) -> torch.Tensor:
    """[K, *n.shape] quantiles from keys sorted along dim 0, where the
    valid keys of each output start at row ``starts`` ([...] broadcast
    against n)."""
    rows = sorted_keys.shape[0]
    out = []
    for qi in q:
        pos = torch.clamp(n - 1, min=0).to(torch.float32) * qi
        lo = torch.floor(pos)
        hi = torch.ceil(pos)
        idx_lo = torch.clamp(starts + lo.long(), 0, rows - 1)
        idx_hi = torch.clamp(starts + hi.long(), 0, rows - 1)
        vlo = key_to_float(torch.gather(sorted_keys, 0, idx_lo))
        vhi = key_to_float(torch.gather(sorted_keys, 0, idx_hi))
        v = vlo + (pos - lo) * (vhi - vlo)
        out.append(torch.where(n > 0, v, 0.0))
    return torch.stack(out)


def _check(vals: torch.Tensor, mask: torch.Tensor) -> None:
    if vals.dim() != 2 or vals.dtype != torch.float32:
        raise ValueError(f"values must be [S, B] float32, got "
                         f"{tuple(vals.shape)} {vals.dtype}")
    if mask.dtype != torch.bool or mask.shape != vals.shape:
        raise ValueError(f"mask must be bool {tuple(vals.shape)}, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if mask.device != vals.device:
        raise ValueError(f"values on {vals.device}, mask on {mask.device}")


def _launch(fn, *args) -> None:
    # The current stream's raw handle (see ops/segment_reduce.py).
    dev = args[0].device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with torch.cuda.device(dev):
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def select_columns_plain(vals: torch.Tensor, mask: torch.Tensor,
                         q) -> torch.Tensor:
    """Plain PyTorch ``select_columns``: a masked sort of the order keys
    along the rows, then the two rank gathers."""
    q = _q_list(q)
    keys = torch.where(mask, order_key(vals), _INVALID)
    n = mask.sum(dim=0)
    if vals.shape[0] == 0:
        return torch.zeros((len(q), vals.shape[1]), device=vals.device)
    skeys = torch.sort(keys, dim=0).values
    return _lerp_ranks(skeys, torch.zeros_like(n)[None], n[None], q)[:, 0]


def select_columns(vals: torch.Tensor, mask: torch.Tensor,
                   q) -> torch.Tensor:
    """[K, B] quantiles ``q`` of each column's valid entries."""
    _check(vals, mask)
    if vals.device.type == "cpu":
        return select_columns_plain(vals, mask, q)
    if vals.device.type != "cuda":
        raise ValueError(f"no kernel for device {vals.device}")
    q = _q_list(q)
    S, B = vals.shape
    if S == 0 or B == 0 or not q:
        return torch.zeros((len(q), B), device=vals.device)
    out = torch.empty((len(q), B), dtype=torch.float32, device=vals.device)
    qh = np.asarray(q, np.float32)
    _launch(_kernels().masked_select_columns, vals.contiguous(),
            mask.contiguous(), S, B, qh.ctypes.data, len(q), out)
    select_columns.launches += 1
    return out


select_columns.launches = 0


def select_groups_plain(vals: torch.Tensor, mask: torch.Tensor,
                        layout: GroupLayout, q) -> torch.Tensor:
    """Plain PyTorch ``select_groups``: rows gathered by group, one sort
    by (group, order key) along them, then the rank gathers at each
    group's offset."""
    q = _q_list(q)
    order, offsets = layout.order.long(), layout.offsets.long()
    G = offsets.shape[0] - 1
    if vals.shape[0] == 0:
        return torch.zeros((len(q), G, vals.shape[1]), device=vals.device)
    v, m = vals[order], mask[order]
    sizes = offsets[1:] - offsets[:-1]
    gid = torch.repeat_interleave(torch.arange(G, device=vals.device),
                                  sizes)
    keys = torch.where(m, order_key(v), _INVALID) + (gid << 32)[:, None]
    skeys = torch.sort(keys, dim=0).values & _INVALID
    csum = torch.cat([torch.zeros_like(m[:1], dtype=torch.int64),
                      torch.cumsum(m, dim=0)])
    n = csum[offsets[1:]] - csum[offsets[:-1]]                   # [G, B]
    starts = offsets[:-1, None].expand_as(n)
    return _lerp_ranks(skeys, starts, n, q)


def select_groups(vals: torch.Tensor, mask: torch.Tensor,
                  layout: GroupLayout, q) -> torch.Tensor:
    """[K, G, B] quantiles ``q`` of each (group, column)'s valid
    entries."""
    _check(vals, mask)
    for name, t in zip(GroupLayout._fields, layout):
        if t.dtype != torch.int32 or t.dim() != 1 or t.device != vals.device:
            raise ValueError(f"layout {name} must be [n] int32 on "
                             f"{vals.device}")
    if layout.order.shape[0] != vals.shape[0]:
        raise ValueError("layout order must list every row")
    if vals.device.type == "cpu":
        return select_groups_plain(vals, mask, layout, q)
    if vals.device.type != "cuda":
        raise ValueError(f"no kernel for device {vals.device}")
    q = _q_list(q)
    S, B = vals.shape
    G = layout.offsets.shape[0] - 1
    if B == 0 or G <= 0 or not q:
        return torch.zeros((len(q), max(G, 0), B), device=vals.device)
    out = torch.empty((len(q), G, B), dtype=torch.float32,
                      device=vals.device)
    qh = np.asarray(q, np.float32)
    _launch(_kernels().masked_select_groups, vals.contiguous(),
            mask.contiguous(), S, B, layout.order.contiguous(),
            layout.offsets.contiguous(), G, layout.big.contiguous(),
            layout.big.shape[0], qh.ctypes.data, len(q), out)
    select_groups.launches += 1
    return out


select_groups.launches = 0
