"""Union-grid interpolate-and-reduce: the CUDA kernel of
``csrc/interp_moments.cu`` and its plain PyTorch version.

For S padded series rows and a sorted grid, each grid point's count,
total, centred M2, min and max over the series' contributions there
(``series_contributions``: an exact sample, else a 'lerp' or 'step'
interpolation inside [first, last], or with 'none' exact samples only).
This is the reduction half of the JAX package's ``group_interpolate``
(``opentsdb_tpu/ops/kernels.py:1100``); the plain version forms the
[S, U] contributions as the JAX package does, the kernel never holds them.

``interp_moments`` takes its plain version only for tensors that lie on
the CPU; for CUDA tensors it launches the kernel on the calling thread's
current stream or raises. ``interp_moments.launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from opentsdb_tpu_torch.ops import cuda_build

INTERPS = ("lerp", "step", "none")
_I32_BIG = 2**31 - 1

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("interp_moments")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.interp_moments_f32.argtypes = [p, p, p, i64, i64, p, i64, i32,
                                           p, p, p, p, p, p]
        lib.interp_moments_f32.restype = ctypes.c_int
        lib.interp_moments_tile.argtypes = [i64, p]
        lib.interp_moments_tile.restype = ctypes.c_int
        _lib = lib
    return _lib


def tile_shape(U: int) -> dict:
    """The tile the kernel launches for ``U`` grid points on the current
    CUDA device: threads per block, grid points per thread and grid points
    per block (four threads take each point, one per quarter of the
    series)."""
    out = (ctypes.c_int32 * 3)()
    rc = _kernels().interp_moments_tile(U, out)
    if rc != 0:
        raise RuntimeError(f"interp_moments_tile failed: CUDA error {rc}")
    return {"threads": out[0], "points_per_thread": out[1],
            "tile_points": out[2]}


def series_contributions(ts: torch.Tensor, vals: torch.Tensor,
                         counts: torch.Tensor, grid: torch.Tensor, *,
                         interp: str = "lerp"):
    """Each series' contribution at every grid point (the JAX package's
    ``series_contributions``, ``opentsdb_tpu/ops/kernels.py:1030``).

    ts/vals are [S, T] left-aligned padded rows; grid is [G] sorted. A
    series contributes its exact value at its own timestamps, an
    interpolation ('lerp' or 'step' last-value-hold) between them, and
    nothing outside [first, last]; 'none' takes exact samples only.
    Returns (contrib [S, G], cmask [S, G])."""
    if interp not in INTERPS:
        raise ValueError(f"unknown interp: {interp}")
    S, T = ts.shape
    idx = torch.arange(T, device=ts.device)
    safe_ts = torch.where(idx[None, :] < counts[:, None], ts, _I32_BIG) \
        .contiguous()
    grid = grid.to(torch.int32)
    pos = torch.searchsorted(
        safe_ts, grid[None, :].expand(S, -1).contiguous(), right=True,
        out_int32=True)
    has_prev = pos > 0
    i0 = torch.clamp(pos - 1, 0, T - 1).long()
    i1 = torch.clamp(pos, 0, T - 1).long()
    x0 = torch.gather(safe_ts, 1, i0)
    y0 = torch.gather(vals, 1, i0)
    exact = has_prev & (x0 == grid[None, :])
    if interp == "none":
        in_range = exact
        interpd = y0
    else:
        in_range = (has_prev & (pos < counts[:, None])) | exact
        if interp == "lerp":
            x1 = torch.gather(safe_ts, 1, i1)
            y1 = torch.gather(vals, 1, i1)
            dx = torch.clamp((x1 - x0).to(torch.float32), min=1e-9)
            t = (grid[None, :] - x0).to(torch.float32) / dx
            interpd = y0 + t * (y1 - y0)
        else:
            interpd = y0
    contrib = torch.where(exact, y0, interpd)
    return torch.where(in_range, contrib, 0.0), in_range


def interp_moments_plain(ts: torch.Tensor, vals: torch.Tensor,
                         counts: torch.Tensor, grid: torch.Tensor, *,
                         interp: str = "lerp", with_m2: bool = True):
    """Plain PyTorch ``interp_moments``: the [S, U] contributions, then
    masked reductions down the series axis, as the JAX package's
    group_interpolate reduces them."""
    contrib, cmask = series_contributions(ts, vals, counts, grid,
                                          interp=interp)
    cnt = cmask.to(torch.float32).sum(dim=0)
    total = torch.where(cmask, contrib, 0.0).sum(dim=0)
    m2 = None
    if with_m2:
        mean = total / torch.clamp(cnt, min=1.0)
        centered = torch.where(cmask, contrib - mean[None, :], 0.0)
        m2 = (centered * centered).sum(dim=0)
    mn = torch.where(cmask, contrib, float("inf")).amin(dim=0)
    mx = torch.where(cmask, contrib, float("-inf")).amax(dim=0)
    return cnt, total, m2, mn, mx


def _check(ts, vals, counts, grid, interp) -> None:
    if interp not in INTERPS:
        raise ValueError(f"unknown interp: {interp}")
    if ts.dim() != 2 or ts.dtype != torch.int32:
        raise ValueError(f"ts must be [S, T] int32, got {tuple(ts.shape)} "
                         f"{ts.dtype}")
    if vals.shape != ts.shape or vals.dtype != torch.float32:
        raise ValueError(f"vals must be float32 {tuple(ts.shape)}, got "
                         f"{tuple(vals.shape)} {vals.dtype}")
    if counts.shape != ts.shape[:1] or counts.dtype != torch.int32:
        raise ValueError(f"counts must be [S] int32, got "
                         f"{tuple(counts.shape)} {counts.dtype}")
    if grid.dim() != 1 or grid.dtype != torch.int32:
        raise ValueError(f"grid must be [U] int32, got {tuple(grid.shape)} "
                         f"{grid.dtype}")
    for t in (vals, counts, grid):
        if t.device != ts.device:
            raise ValueError(f"inputs on {ts.device} and {t.device}")


def interp_moments(ts: torch.Tensor, vals: torch.Tensor,
                   counts: torch.Tensor, grid: torch.Tensor, *,
                   interp: str = "lerp", with_m2: bool = True):
    """Per grid point of [U] sorted ``grid``: (count, total, m2, min, max)
    [U] float32 over the series' contributions; m2 is None unless
    ``with_m2``. ``ts`` [S, T] int32 rows sorted with their first
    ``counts`` [S] entries real, ``vals`` [S, T] float32."""
    _check(ts, vals, counts, grid, interp)
    if ts.device.type == "cpu":
        return interp_moments_plain(ts, vals, counts, grid, interp=interp,
                                    with_m2=with_m2)
    if ts.device.type != "cuda":
        raise ValueError(f"no kernel for device {ts.device}")
    U = grid.shape[0]
    out = [torch.empty(U, dtype=torch.float32, device=ts.device)
           for _ in range(5)]
    if not with_m2:
        out[2] = None
    if U == 0:
        return tuple(None if o is None else o.zero_() for o in out)
    ts, vals, counts, grid = (t.contiguous() for t in (ts, vals, counts,
                                                         grid))
    stream = torch._C._cuda_getCurrentRawStream(ts.device.index)
    fn = _kernels().interp_moments_f32
    with torch.cuda.device(ts.device):
        rc = fn(ts.data_ptr(), vals.data_ptr(), counts.data_ptr(),
                ts.shape[0], ts.shape[1], grid.data_ptr(), U,
                INTERPS.index(interp),
                *(None if o is None else o.data_ptr() for o in out), stream)
    if rc != 0:
        raise RuntimeError(f"interp_moments_f32 launch failed: CUDA error "
                           f"{rc}")
    interp_moments.launches += 1
    return tuple(out)


interp_moments.launches = 0
