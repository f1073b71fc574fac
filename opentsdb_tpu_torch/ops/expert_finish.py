"""The expert dashboard's finishing step: the CUDA kernel of
``csrc/expert.cu`` and its plain PyTorch version.

``dash_finish`` is ``opentsdb_tpu/parallel/expert.py``'s
``_finish_switch`` over a whole shard's slots at once: each slot's
[cells] moments (count, sum, centered M2, min, max) finished by the
aggregator its code names, in ``DASH_AGGS`` order. The dashboard body
(``parallel/expert.py``) runs it twice a moment slot, over the series
stage with the slots' downsamplers and over the group moments with
their group aggregators, and once a percentile slot, over its series
stage. It replaces no Pallas kernel: the JAX body selects among XLA's
finished aggregators. The source file says what bounds it and how it
rounds.

The wrapper takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel on the calling thread's current
stream or raises. ``dash_finish.launches`` counts kernel launches and
nothing else. The kernel equals its plain version bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from opentsdb_tpu_torch.ops import cuda_build
from opentsdb_tpu_torch.ops.kernels import _finish

# _finish's aggregators, in the kernel's (and the JAX package's
# DASH_AGGS) order.
DASH_AGGS = ("sum", "min", "max", "avg", "dev", "count")
PLANES = ("count", "total", "m2", "min", "max")
# The planes each aggregator code reads.
CODE_NEEDS = ({"total"}, {"min"}, {"max"}, {"count", "total"},
              {"count", "m2"}, {"count"})
MAX_SLOTS = 65535

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("expert")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.dash_finish_f32.argtypes = [p, p, p, p, p, p, i32, i64, p, p]
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
    """The planes a launch over slots of ``codes`` reads."""
    out: set = set()
    for c in codes:
        out |= CODE_NEEDS[int(c)]
    return frozenset(out)


def dash_finish_plain(count, total, m2, mn, mx, codes) -> torch.Tensor:
    """Plain ``dash_finish``: each slot's row through ``kernels._finish``
    of its aggregator."""
    planes = (count, total, m2, mn, mx)
    ref = next(p for p in planes if p is not None)
    out = torch.empty(ref.shape, dtype=torch.float32, device=ref.device)
    for q, code in enumerate(codes):
        row = [None if p is None else p[q] for p in planes]
        out[q] = _finish(DASH_AGGS[int(code)], *row)
    return out


def bytes_moved(codes, cells: int) -> int:
    """What one launch must move: each slot's needed planes read once,
    its values written once, the codes read."""
    return sum(4 * cells * (len(CODE_NEEDS[int(c)]) + 1)
               for c in codes) + 4 * len(codes)


def dash_finish(count: torch.Tensor | None, total: torch.Tensor | None,
                m2: torch.Tensor | None, mn: torch.Tensor | None,
                mx: torch.Tensor | None, codes) -> torch.Tensor:
    """Finish [Q, cells] float32 moment planes (count, sum, centered m2,
    min, max) slot by slot: slot q by the aggregator ``codes[q]`` (host
    ints, ``DASH_AGGS`` order). Returns [Q, cells] float32. A plane no
    slot's code reads (``needs``) may be None."""
    codes = [int(c) for c in codes]
    planes = dict(zip(PLANES, (count, total, m2, mn, mx)))
    want = needs(codes)
    ref = next((planes[n] for n in PLANES if n in want), None)
    if ref is None:
        raise ValueError("dash_finish: no slots")
    Q = len(codes)
    if ref.dim() != 2 or ref.shape[0] != Q:
        raise ValueError(f"dash_finish: planes must be [{Q}, cells], got "
                         f"{tuple(ref.shape)}")
    if any(not 0 <= c < len(DASH_AGGS) for c in codes):
        raise ValueError(f"dash_finish: codes must be in [0, "
                         f"{len(DASH_AGGS)})")
    for name in want:
        t = planes[name]
        if t is None or t.shape != ref.shape \
                or t.dtype != torch.float32 or t.device != ref.device:
            raise ValueError(f"dash_finish: a slot needs a "
                             f"{tuple(ref.shape)} float32 {name} plane on "
                             f"{ref.device}")
    if ref.device.type == "cpu":
        return dash_finish_plain(count, total, m2, mn, mx, codes)
    if ref.device.type != "cuda":
        raise ValueError(f"no kernel for device {ref.device}")
    if Q > MAX_SLOTS:
        raise ValueError(f"dash_finish: {Q} slots, at most {MAX_SLOTS}")
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
    _launch(_kernels().dash_finish_f32, ref.get_device(), *ptrs,
            code_t.data_ptr(), Q, cells, out.data_ptr())
    dash_finish.launches += 1
    return out


dash_finish.launches = 0
