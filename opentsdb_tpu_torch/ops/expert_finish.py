"""The expert dashboard's finish: the CUDA kernels of ``csrc/expert.cu``
and their plain PyTorch versions.

``dash_finish`` is the per-slot tail of the dashboard body of
``opentsdb_tpu/parallel/expert.py`` for a whole shard's slots at once:
from the series stage's segment moments (count, sum, centered M2, min,
max; [Q, S * B] planes) it finishes each slot's series by its downsampler
(``_dash_series_stage``'s ``_finish_switch``), fills each series' gaps
(``gap_fill``) and, for a moment shard, reduces over the series
(``group_moments``) and finishes by the slot's group aggregator
(``_finish_switch``), in one launch; for a percentile shard it stops
after the fill. Codes are in ``DASH_AGGS`` order. It replaces no Pallas
kernel: the JAX body runs those steps as XLA ops. The source file says
what bounds it and how it rounds.

``finish_cells`` is the first of those steps alone over [Q, cells]
planes, the per-cell finish the dashboard body ran before the fused
kernel, twice a moment slot; ``finish_cells_plain`` is its arithmetic,
which ``dash_finish_plain`` runs. No path launches ``finish_cells``:
``chip_smoke.py`` times that chain beside ``dash_finish``.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel on the calling thread's current
stream or raises. ``launches`` on each wrapper counts kernel launches and
nothing else. ``finish_cells`` equals its plain version bit for bit;
``dash_finish``'s filled grid, masks, counts, min and max do too, and its
sums and deviations agree to float32 tolerance (the kernel sums over the
series in its own order).
"""

from __future__ import annotations

import ctypes

import torch

from opentsdb_tpu_torch.ops import cuda_build
from opentsdb_tpu_torch.ops.kernels import _finish, gap_fill, group_moments

# _finish's aggregators, in the kernel's (and the JAX package's
# DASH_AGGS) order.
DASH_AGGS = ("sum", "min", "max", "avg", "dev", "count")
PLANES = ("count", "total", "m2", "min", "max")
# The planes each aggregator code reads.
CODE_NEEDS = ({"total"}, {"min"}, {"max"}, {"count", "total"},
              {"count", "m2"}, {"count"})
MAX_SLOTS = 65535
MAX_CELLS = 2**31 - 1      # S * B of a slot

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("expert")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.finish_cells_f32.argtypes = [p, p, p, p, p, p, i32, i64, p, p]
        lib.finish_cells_f32.restype = ctypes.c_int
        lib.dash_finish_f32.argtypes = [p, p, p, i32, i32, i32, i32, p, p,
                                        p, p]
        lib.dash_finish_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(fn, dev: int, *args) -> None:
    """Launch on the current stream of card ``dev``; the device guard is
    entered only when ``dev`` is not the thread's current card."""
    if dev == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def needs(codes) -> frozenset:
    """The planes a per-cell finish over slots of ``codes`` reads."""
    out: set = set()
    for c in codes:
        out |= CODE_NEEDS[int(c)]
    return frozenset(out)


def _codes(codes, what: str) -> list:
    codes = [int(c) for c in codes]
    if any(not 0 <= c < len(DASH_AGGS) for c in codes):
        raise ValueError(f"{what}: codes must be in [0, {len(DASH_AGGS)})")
    return codes


def _check_planes(what, planes: dict, want, Q: int):
    """The first needed plane, after checking that every needed plane is
    a [Q, cells] float32 tensor on its device."""
    if not want:
        raise ValueError(f"{what}: no slots")
    ref = next((planes[n] for n in PLANES
                if n in want and planes[n] is not None), None)
    if ref is None:
        raise ValueError(f"{what}: a slot needs the {sorted(want)} "
                         f"planes")
    if ref.dim() != 2 or ref.shape[0] != Q:
        raise ValueError(f"{what}: planes must be [{Q}, cells], got "
                         f"{tuple(ref.shape)}")
    for name in want:
        t = planes[name]
        if t is None or t.shape != ref.shape \
                or t.dtype != torch.float32 or t.device != ref.device:
            raise ValueError(f"{what}: a slot needs a {tuple(ref.shape)} "
                             f"float32 {name} plane on {ref.device}")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {ref.device}")
    return ref


# ---------------------------------------------------------------------------
# finish_cells: the per-cell finish
# ---------------------------------------------------------------------------

def finish_cells_plain(count, total, m2, mn, mx, codes) -> torch.Tensor:
    """Plain ``finish_cells``: each slot's row through ``kernels._finish``
    of its aggregator."""
    planes = (count, total, m2, mn, mx)
    ref = next(p for p in planes if p is not None)
    out = torch.empty(ref.shape, dtype=torch.float32, device=ref.device)
    for q, code in enumerate(codes):
        row = [None if p is None else p[q] for p in planes]
        out[q] = _finish(DASH_AGGS[int(code)], *row)
    return out


def finish_cells_bytes(codes, cells: int) -> int:
    """What one ``finish_cells`` launch must move: each slot's needed
    planes read once, its values written once, the codes read."""
    return sum(4 * cells * (len(CODE_NEEDS[int(c)]) + 1)
               for c in codes) + 4 * len(codes)


def finish_cells(count: torch.Tensor | None, total: torch.Tensor | None,
                 m2: torch.Tensor | None, mn: torch.Tensor | None,
                 mx: torch.Tensor | None, codes) -> torch.Tensor:
    """Finish [Q, cells] float32 moment planes (count, sum, centered m2,
    min, max) slot by slot: slot q by the aggregator ``codes[q]`` (host
    ints, ``DASH_AGGS`` order). Returns [Q, cells] float32. A plane no
    slot's code reads (``needs``) may be None."""
    codes = _codes(codes, "finish_cells")
    planes = dict(zip(PLANES, (count, total, m2, mn, mx)))
    want = needs(codes)
    ref = _check_planes("finish_cells", planes, want, len(codes))
    if ref.device.type == "cpu":
        return finish_cells_plain(count, total, m2, mn, mx, codes)
    Q = len(codes)
    if Q > MAX_SLOTS:
        raise ValueError(f"finish_cells: {Q} slots, at most {MAX_SLOTS}")
    cells = ref.shape[1]
    out = torch.empty(ref.shape, dtype=torch.float32, device=ref.device)
    if cells == 0:
        return out
    # The contiguous planes and the codes live until the launch is
    # queued.
    keep = {name: planes[name].contiguous() for name in want}
    code_t = torch.tensor(codes, dtype=torch.int32).to(ref.device,
                                                       non_blocking=True)
    ptrs = [keep[n].data_ptr() if n in keep else None for n in PLANES]
    _launch(_kernels().finish_cells_f32, ref.get_device(), *ptrs,
            code_t.data_ptr(), Q, cells, out.data_ptr())
    finish_cells.launches += 1
    return out


finish_cells.launches = 0


# ---------------------------------------------------------------------------
# dash_finish: a shard's series finish, fill and group finish in one launch
# ---------------------------------------------------------------------------

def dash_needs(ds_codes) -> frozenset:
    """The planes ``dash_finish`` reads for slots of downsamplers
    ``ds_codes``: count (the series mask) and what each finish reads."""
    return needs(ds_codes) | {"count"}


def dash_finish_plain(count, total, m2, mn, mx, ds_codes, agg_codes=None,
                      *, num_series: int, num_buckets: int):
    """Plain ``dash_finish``: the chain the kernel fuses, as the
    dashboard body ran it: ``finish_cells_plain`` by the downsamplers,
    ``gap_fill`` over the [Q * S, B] rows, then (a moment shard)
    ``group_moments`` over the [S, Q * B] view and ``finish_cells_plain``
    by the group aggregators."""
    Q, S, B = len(ds_codes), num_series, num_buckets
    per = finish_cells_plain(count, total, m2, mn, mx, ds_codes)
    sm = (count > 0).reshape(Q * S, B)
    filled, in_range = gap_fill(per.reshape(Q * S, B), sm, B)
    gm = sm.reshape(Q, S, B).any(dim=1)
    if agg_codes is None:
        return filled.reshape(Q, S, B), in_range.reshape(Q, S, B), gm
    f2 = filled.reshape(Q, S, B).permute(1, 0, 2).reshape(S, Q * B)
    r2 = in_range.reshape(Q, S, B).permute(1, 0, 2).reshape(S, Q * B)
    g_n, g_total, g_m2, _, g_mn, g_mx = group_moments(f2, r2)
    gv = finish_cells_plain(*(x.reshape(Q, B) for x in
                              (g_n, g_total, g_m2, g_mn, g_mx)), agg_codes)
    return gv, gm


def dash_bytes(ds_codes, fill: bool, num_series: int,
               num_buckets: int) -> int:
    """What one ``dash_finish`` launch must move: each slot's count and
    downsampler planes read once, its outputs written once (values and
    group mask; in fill mode the filled grid, its in-range flags and the
    group mask), the codes read."""
    cells = num_series * num_buckets
    out = (5 * cells + num_buckets) if fill else 5 * num_buckets
    return sum(4 * cells * len(CODE_NEEDS[int(c)] | {"count"}) + out
               for c in ds_codes) + 8 * len(ds_codes)


def dash_finish(count: torch.Tensor, total: torch.Tensor | None,
                m2: torch.Tensor | None, mn: torch.Tensor | None,
                mx: torch.Tensor | None, ds_codes, agg_codes=None, *,
                num_series: int, num_buckets: int):
    """Finish a dashboard shard's Q slots from their series stage's
    [Q, S * B] float32 moment planes (count, sum, centered m2, min, max;
    views of any strides), ``ds_codes`` the slots' downsamplers and
    ``agg_codes`` their group aggregators (host ints, ``DASH_AGGS``
    order). A moment shard (``agg_codes`` given) returns (values [Q, B]
    float32, group mask [Q, B] bool); a percentile shard (``agg_codes``
    None) returns (filled [Q, S, B] float32, in_range [Q, S, B] bool,
    group mask [Q, B] bool). The group mask is any series' count > 0. A
    plane no downsampler reads (``dash_needs``) may be None."""
    ds = _codes(ds_codes, "dash_finish")
    agg = None if agg_codes is None else _codes(agg_codes, "dash_finish")
    Q, S, B = len(ds), num_series, num_buckets
    if agg is not None and len(agg) != Q:
        raise ValueError(f"dash_finish: {Q} downsamplers, {len(agg)} "
                         f"group aggregators")
    if Q > MAX_SLOTS:
        raise ValueError(f"dash_finish: {Q} slots, at most {MAX_SLOTS}")
    if S < 1 or B < 1 or S * B > MAX_CELLS:
        raise ValueError(f"dash_finish: S = {S}, B = {B}: S, B >= 1 and "
                         f"S * B < 2^31")
    planes = dict(zip(PLANES, (count, total, m2, mn, mx)))
    want = dash_needs(ds)
    ref = _check_planes("dash_finish", planes, want, Q)
    if ref.shape[1] != S * B:
        raise ValueError(f"dash_finish: planes of {ref.shape[1]} cells, "
                         f"S * B = {S * B}")
    if ref.device.type == "cpu":
        return dash_finish_plain(count, total, m2, mn, mx, ds, agg,
                                 num_series=S, num_buckets=B)
    dev = ref.device
    gm = torch.empty((Q, B), dtype=torch.bool, device=dev)
    if agg is None:
        out = torch.empty((Q, S, B), dtype=torch.float32, device=dev)
        in_range = torch.empty((Q, S, B), dtype=torch.bool, device=dev)
        res = (out, in_range, gm)
    else:
        out = torch.empty((Q, B), dtype=torch.float32, device=dev)
        in_range = None
        res = (out, gm)
    if Q == 0:
        return res
    used = [planes[n] if n in want else None for n in PLANES]
    ptrs = (ctypes.c_void_p * 5)(
        *(None if t is None else t.data_ptr() for t in used))
    strides = (ctypes.c_int64 * 10)(
        *(0 if t is None else t.stride(0) for t in used),
        *(0 if t is None else t.stride(1) for t in used))
    code_t = torch.tensor(ds + (agg or [0] * Q), dtype=torch.int32).to(
        dev, non_blocking=True)
    _launch(_kernels().dash_finish_f32, ref.get_device(), ptrs, strides,
            code_t.data_ptr(), Q, S, B, int(agg is None), out.data_ptr(),
            None if in_range is None else in_range.data_ptr(),
            gm.data_ptr())
    dash_finish.launches += 1
    return res


dash_finish.launches = 0
