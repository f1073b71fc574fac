"""The mesh plane's cross-shard combines: the CUDA kernels of
``csrc/mesh_combine.cu`` and their plain PyTorch versions.

``moment_combine`` merges D shards' per-cell partial moments into the
group aggregate (the psum / pmin / pmax fan-in and ``_finish`` of
``opentsdb_tpu/parallel/sharded.py``'s group and multigroup bodies);
``hybrid_moment_combine`` is the two-level merge of
``opentsdb_tpu/parallel/multihost.py``'s hybrid group body (a host
row's chips, then the rows), or its first level alone, the row partials
a process ships across the mesh plane;
``tile_carries`` selects each (tile, series)'s cross-tile carries from
the gathered tile summaries (``opentsdb_tpu/parallel/timeshard.py``
``_cross_tile_edges`` and the rate body's predecessor search). None
replaces a Pallas kernel: the JAX package does these with XLA
collectives.
The source file says what bounds each kernel and how it rounds.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel on the calling thread's current
stream or raises. ``launches`` on each wrapper counts kernel launches
and nothing else. Both kernels equal their plain versions bit for bit:
the sums run in shard order with no fused multiply-add, and the carries
only select.
"""

from __future__ import annotations

import ctypes

import torch

from opentsdb_tpu_torch.core.const import NOLERP_AGGS
from opentsdb_tpu_torch.ops import cuda_build
from opentsdb_tpu_torch.ops.kernels import _finish

# _finish's aggregators, as the kernel numbers them.
AGG_CODES = {"sum": 0, "min": 1, "max": 2, "avg": 3, "dev": 4, "count": 5}
_I32_BIG = 2**31 - 1

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("mesh_combine")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.moment_combine_f32.argtypes = [p, p, p, p, p, p, i32, i64, i32,
                                           p, p, p]
        lib.moment_combine_f32.restype = ctypes.c_int
        lib.tile_carries_i32f32.argtypes = [p, i32, i64, i32, p, p]
        lib.tile_carries_i32f32.restype = ctypes.c_int
        lib.hybrid_moment_combine_f32.argtypes = [p] * 7 + [
            i32, i32, i64, i32, i32] + [p] * 10
        lib.hybrid_moment_combine_f32.restype = ctypes.c_int
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


def agg_code(agg: str) -> int:
    return AGG_CODES[NOLERP_AGGS.get(agg, agg)]


def needs(agg: str) -> frozenset:
    """The partial planes ``moment_combine`` reads for ``agg``."""
    code = agg_code(agg)
    return {0: frozenset({"total"}), 1: frozenset({"min"}),
            2: frozenset({"max"}), 3: frozenset({"n", "total"}),
            4: frozenset({"n", "total", "m2"}),
            5: frozenset({"n"})}[code]


# ---------------------------------------------------------------------------
# moment_combine
# ---------------------------------------------------------------------------

def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    acc = x[0]
    for d in range(1, x.shape[0]):
        acc = acc + x[d]
    return acc


def moment_combine_plain(n, total, m2, mn, mx, any_, agg: str):
    """Plain ``moment_combine``: the same operations in the same order."""
    code = agg_code(agg)
    g_n = _sum_rows(n)
    mask = (any_ != 0).any(dim=0)
    safe = torch.clamp(g_n, min=1.0)
    if code in (0, 3, 4):
        g_t = _sum_rows(total)
        v = g_t / safe if code == 3 else g_t
        if code == 4:
            g_mean = g_t / safe
            dd = total / torch.clamp(n, min=1.0) - g_mean[None]
            g_m2 = _sum_rows(m2 + n * (dd * dd))
            v = torch.sqrt(torch.clamp(g_m2, min=0.0) / safe)
    elif code in (1, 2):
        x = mn if code == 1 else mx
        v = x[0]
        for d in range(1, x.shape[0]):
            beat = x[d] < v if code == 1 else x[d] > v
            v = torch.where(beat | torch.isnan(x[d]), x[d], v)
    else:
        v = g_n
    return v, mask


def moment_combine(n: torch.Tensor, total: torch.Tensor | None,
                   m2: torch.Tensor | None, mn: torch.Tensor | None,
                   mx: torch.Tensor | None, any_: torch.Tensor, *,
                   agg: str):
    """Merge [D, C] float32 partials (count, sum, centered m2, min, max;
    ``any_`` [D, C] int32) over the D shards into (value [C] float32,
    mask [C] bool): Chan et al.'s exact pairwise moment merge, shard by
    shard in order, then the aggregator ``agg``. The planes ``agg`` does
    not read (``needs``) may be None; the counts give the shape and are
    read only by avg, dev and count."""
    want = needs(agg)
    planes = {"n": n, "total": total, "m2": m2, "min": mn, "max": mx}
    if n.dim() != 2 or n.dtype != torch.float32:
        raise ValueError(f"moment_combine: counts must be [D, C] float32, "
                         f"got {tuple(n.shape)} {n.dtype}")
    for name, t in planes.items():
        if name in want and (t is None or t.shape != n.shape
                             or t.dtype != torch.float32
                             or t.device != n.device):
            raise ValueError(f"moment_combine: {agg} needs a [D, C] "
                             f"float32 {name} plane on {n.device}")
    if any_.shape != n.shape or any_.dtype != torch.int32 \
            or any_.device != n.device:
        raise ValueError("moment_combine: any must be [D, C] int32 "
                         "beside the counts")
    if n.device.type == "cpu":
        return moment_combine_plain(n, total, m2, mn, mx, any_, agg)
    if n.device.type != "cuda":
        raise ValueError(f"no kernel for device {n.device}")
    D, C = n.shape
    out = torch.empty(C, dtype=torch.float32, device=n.device)
    mask = torch.empty(C, dtype=torch.bool, device=n.device)
    if C == 0 or D == 0:
        return out, torch.zeros_like(mask)

    # The contiguous planes live until the launch is queued: a copy freed
    # before it could hand its block to the next plane's copy.
    keep = {name: planes[name].contiguous() for name in want}
    keep["any"] = any_.contiguous()
    ptrs = [keep[k].data_ptr() if k in keep else None
            for k in ("n", "total", "m2", "min", "max", "any")]
    _launch(_kernels().moment_combine_f32, n.get_device(), *ptrs, D, C,
            agg_code(agg), out.data_ptr(), mask.data_ptr())
    moment_combine.launches += 1
    return out, mask


moment_combine.launches = 0


# ---------------------------------------------------------------------------
# tile_carries
# ---------------------------------------------------------------------------

def tile_carries_plain(rows: torch.Tensor, mode: int) -> torch.Tensor:
    """Plain ``tile_carries``: the JAX bodies' argmax / argmin
    selections (the first extreme wins), for every tile at once."""
    D = rows.shape[0]
    e = torch.arange(D, dtype=torch.int32, device=rows.device)
    before = (e[:, None] < e[None, :])[:, :, None]       # [e, d, 1]: e < d
    after = (e[:, None] > e[None, :])[:, :, None]        # e > d
    if mode == 0:
        last_i, last_v = rows[:, None, :, 0], rows[:, :, 1]
        first_i, first_v = rows[:, None, :, 2], rows[:, :, 3]
        lcand = torch.where(before & (last_i >= 0), last_i, -1)
        lsel = torch.argmax(lcand, dim=0)                 # [d, S]
        rcand = torch.where(after & (first_i < _I32_BIG), first_i,
                            _I32_BIG)
        rsel = torch.argmin(rcand, dim=0)
        return torch.stack([
            torch.gather(lcand, 0, lsel[None])[0],
            torch.gather(last_v, 0, lsel),
            torch.gather(rcand, 0, rsel[None])[0],
            torch.gather(first_v, 0, rsel)])
    has = rows[:, None, :, 0] > 0
    cand = torch.where(before & has, e[:, None, None], -1)
    sel = torch.argmax(cand, dim=0)
    has_carry = (torch.gather(cand, 0, sel[None])[0] >= 0).to(torch.int32)
    return torch.stack([has_carry, torch.gather(rows[:, :, 1], 0, sel),
                        torch.gather(rows[:, :, 2], 0, sel),
                        torch.zeros_like(has_carry)])


def tile_carries(rows: torch.Tensor, mode: int) -> torch.Tensor:
    """Cross-tile carries from gathered per-tile summaries ``rows``
    [D, S, 4] int32 (float values as their bits). ``mode`` 0: rows are
    (last idx, last value, first idx, first value) and the result planes
    (left_idx, left_val, right_idx, right_val); mode 1: rows are (has,
    last ts, last value, unused) and the planes (has_carry, carry_ts,
    carry_val, 0). Returns [4, D, S] int32."""
    if rows.dim() != 3 or rows.shape[2] != 4 or rows.dtype != torch.int32:
        raise ValueError(f"tile_carries: rows must be [D, S, 4] int32, "
                         f"got {tuple(rows.shape)} {rows.dtype}")
    if mode not in (0, 1):
        raise ValueError(f"tile_carries: mode must be 0 or 1, got {mode}")
    if rows.device.type == "cpu":
        return tile_carries_plain(rows, mode)
    if rows.device.type != "cuda":
        raise ValueError(f"no kernel for device {rows.device}")
    D, S = rows.shape[:2]
    rows = rows.contiguous()
    if rows.data_ptr() % 16:  # the kernel loads a row as one int4
        rows = rows.clone()
    out = torch.empty((4, D, S), dtype=torch.int32, device=rows.device)
    if D == 0 or S == 0:
        return out
    _launch(_kernels().tile_carries_i32f32, rows.get_device(),
            rows.data_ptr(), D, S, mode, out.data_ptr())
    tile_carries.launches += 1
    return out


tile_carries.launches = 0


# ---------------------------------------------------------------------------
# hybrid_moment_combine
# ---------------------------------------------------------------------------

# The rows one launch merges (the kernel keeps them in registers).
HYBRID_MAX_HOSTS = 16
HYBRID_PLANES = ("n", "total", "m2", "mean", "min", "max")


def hybrid_needs(agg: str) -> frozenset:
    """The partial planes ``hybrid_moment_combine`` reads (and emits)
    for ``agg``: ``needs`` and, for dev, the shipped means."""
    want = needs(agg)
    return want | {"mean"} if "m2" in want else want


def _chan_plain(p: dict, dim: int, dev: bool) -> dict:
    """One chan level over dimension ``dim`` (members in order); a level
    of one member is the member."""
    k = p["any"].shape[dim]

    def member(name, i):
        x = p[name]
        return None if x is None else x.select(dim, i)

    if k == 1:
        return {name: member(name, 0) for name in p}
    acc = {name: member(name, 0) for name in p}
    acc["any"] = acc["any"] != 0
    for i in range(1, k):
        for name in ("n", "total"):
            if acc[name] is not None:
                acc[name] = acc[name] + member(name, i)
        for name, beat in (("min", torch.lt), ("max", torch.gt)):
            if acc[name] is not None:
                x = member(name, i)
                acc[name] = torch.where(beat(x, acc[name]) | torch.isnan(x),
                                        x, acc[name])
        acc["any"] = acc["any"] | (member("any", i) != 0)
    acc["any"] = acc["any"].to(torch.int32)
    if acc["n"] is not None and acc["total"] is not None:
        acc["mean"] = acc["total"] / torch.clamp(acc["n"], min=1.0)
    if dev:
        m2 = None
        for i in range(k):
            d = member("mean", i) - acc["mean"]
            term = member("m2", i) + member("n", i) * (d * d)
            m2 = term if m2 is None else m2 + term
        acc["m2"] = m2
    return acc


def hybrid_moment_combine_plain(n, total, m2, mean, mn, mx, any_, agg: str,
                                emit: bool = False):
    """Plain ``hybrid_moment_combine``: the same operations in the same
    order."""
    code = agg_code(agg)
    want = hybrid_needs(agg)
    planes = {"n": n, "total": total, "m2": m2, "mean": mean, "min": mn,
              "max": mx}
    p = {name: (x if name in want else None) for name, x in planes.items()}
    p["any"] = any_
    rows = _chan_plain(p, 1, code == 4)
    if emit:
        return tuple(rows[name] if name in want else None
                     for name in HYBRID_PLANES) + (rows["any"],)
    g = _chan_plain(rows, 0, code == 4)
    v = _finish(agg, g["n"], g["total"], g["m2"], g["min"], g["max"])
    return v, g["any"] != 0


def hybrid_moment_combine(n, total, m2, mean, mn, mx, any_, *, agg: str,
                          emit: bool = False):
    """Merge [H, C, cells] float32 partials (count, sum, centered m2,
    mean, min, max; ``any_`` [H, C, cells] int32) of H host rows of C
    chips: the chips of each row in chip order, then the rows in row
    order (Chan et al.'s exact pairwise update at each level, JAX's
    ``_hybrid_group_body``), then the aggregator ``agg``: (value [cells]
    float32, mask [cells] bool). ``emit``: stop after the first level and
    return each row's partials, ``HYBRID_PLANES`` then any, [H, cells]
    each (None for the planes ``agg`` does not read): what a process
    ships across the mesh plane. A finish over the gathered rows as
    [H, 1, cells] gives the bits of the finish over [H, C, cells]. The
    planes ``agg`` does not read (``hybrid_needs``) may be None."""
    want = hybrid_needs(agg)
    planes = {"n": n, "total": total, "m2": m2, "mean": mean, "min": mn,
              "max": mx}
    if any_.dim() != 3 or any_.dtype != torch.int32:
        raise ValueError(f"hybrid_moment_combine: any must be [H, C, "
                         f"cells] int32, got {tuple(any_.shape)} "
                         f"{any_.dtype}")
    for name in want:
        t = planes[name]
        if t is None or t.shape != any_.shape \
                or t.dtype != torch.float32 or t.device != any_.device:
            raise ValueError(f"hybrid_moment_combine: {agg} needs a [H, "
                             f"C, cells] float32 {name} plane on "
                             f"{any_.device}")
    H, C, cells = any_.shape
    if H > HYBRID_MAX_HOSTS:
        raise ValueError(f"hybrid_moment_combine: {H} host rows, at most "
                         f"{HYBRID_MAX_HOSTS}")
    if any_.device.type == "cpu":
        return hybrid_moment_combine_plain(n, total, m2, mean, mn, mx,
                                           any_, agg, emit)
    if any_.device.type != "cuda":
        raise ValueError(f"no kernel for device {any_.device}")
    dev = any_.device
    keep = {name: planes[name].contiguous() for name in want}
    keep["any"] = any_.contiguous()
    ins = [keep[k].data_ptr() if k in keep else None
           for k in (*HYBRID_PLANES, "any")]
    if emit:
        outs = {name: torch.empty((H, cells), dtype=torch.float32,
                                  device=dev) for name in want}
        outs["any"] = torch.empty((H, cells), dtype=torch.int32,
                                  device=dev)
        eptr = [outs[k].data_ptr() if k in outs else None
                for k in (*HYBRID_PLANES, "any")]
        res = tuple(outs.get(k) for k in HYBRID_PLANES) + (outs["any"],)
        optr = [None, None]
    else:
        out = torch.empty(cells, dtype=torch.float32, device=dev)
        mask = torch.empty(cells, dtype=torch.bool, device=dev)
        if cells == 0 or H == 0 or C == 0:
            return out, torch.zeros_like(mask)
        eptr = [None] * 7
        res = (out, mask)
        optr = [out.data_ptr(), mask.data_ptr()]
    if cells == 0 or H == 0 or C == 0:
        return res
    _launch(_kernels().hybrid_moment_combine_f32, dev.index, *ins, H, C,
            cells, agg_code(agg), int(emit), *optr, *eptr)
    hybrid_moment_combine.launches += 1
    return res


hybrid_moment_combine.launches = 0
