"""Batched TSST4 block decode: the CUDA kernel of ``csrc/block_decode.cu``
and its plain PyTorch version.

``decode_points`` is the port of the JAX package's XLA function
``opentsdb_tpu/compress/kernels.py`` ``decode_points`` (with its helpers
``_varbytes_u32``, ``_unzigzag32`` and ``_seg_cumsum``): the concatenated
payload streams of whole TSST4 blocks in, per-point qualifier deltas
(``rel_ts``, plus ``rel_base``) and float32 values out, under every query
the fused plan serves (``compress/kernels.py``). The source file says how
the kernel is built for Hopper and what bounds it.

Inputs, per point (all int32 unless said): ``ts_nb`` / ``v_nb`` the
significant byte counts of the timestamp entry and the value word,
``ts_pay`` / ``v_pay`` the packed payload bytes (uint8, any length,
empty included), ``first_idx`` the index of the point's record's first
point, ``blk_first`` the index of its block's first point, and
``rel_base`` the record's base time as [P] int32 or one int for every
point. ``vkind`` is "f32" (TSF32: XOR chain, bitcast) or "int" (TSINT:
zigzag-delta chain, int32 -> float32 cast). Outputs equal the JAX
function's bit for bit: the int32 sums wrap, indices clamp as XLA's
gathers clamp.

The wrapper takes the plain version only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel on the calling thread's current
stream or raises. ``decode_points.launches`` counts kernel calls (one per
decode, whatever the launches inside), so a run can show that its path
went through the kernel.

The kernel's tiles publish their scan prefixes in status words that
outlive the call: one buffer a (card, stream), zeroed once when it is
made or grown, each call's words tagged with a sequence number of its
own, so no call resets them. Calls on one stream run in order; calls on
two streams use two buffers.
"""

from __future__ import annotations

import ctypes
import itertools
import threading

import torch

from opentsdb_tpu_torch.ops import cuda_build

_lib = None
_VKINDS = ("f32", "int")
_M32 = 0xFFFFFFFF
_state: dict = {}
_state_lock = threading.Lock()
_tags = itertools.count()


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("block_decode")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.block_decode_scratch_words.argtypes = [i64]
        lib.block_decode_scratch_words.restype = i64
        lib.block_decode_state_words.argtypes = [i64]
        lib.block_decode_state_words.restype = i64
        lib.block_decode_points.argtypes = [p, p, i64, p, p, i64, p, p, p,
                                            i32, i32, i64, p,
                                            ctypes.c_uint32, p, p, p, p]
        lib.block_decode_points.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(ts_nb, ts_pay, v_nb, v_pay, first_idx, blk_first, rel_base,
           vkind):
    if vkind not in _VKINDS:
        raise ValueError(f"vkind must be one of {_VKINDS}, got {vkind!r}")
    n = ts_nb.shape[0] if ts_nb.dim() == 1 else -1
    for name, t in (("ts_nb", ts_nb), ("v_nb", v_nb),
                    ("first_idx", first_idx), ("blk_first", blk_first)):
        if t.dim() != 1 or t.dtype != torch.int32 or t.shape[0] != n:
            raise ValueError(f"{name} must be [P] int32 like ts_nb, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("ts_pay", ts_pay), ("v_pay", v_pay)):
        if t.dim() != 1 or t.dtype != torch.uint8:
            raise ValueError(f"{name} must be 1-d uint8, got "
                             f"{tuple(t.shape)} {t.dtype}")
    tensors = [ts_nb, ts_pay, v_nb, v_pay, first_idx, blk_first]
    if isinstance(rel_base, torch.Tensor) and rel_base.dim() == 1:
        if rel_base.dtype != torch.int32 or rel_base.shape[0] != n:
            raise ValueError(f"rel_base must be [P] int32 or a scalar, got "
                             f"{tuple(rel_base.shape)} {rel_base.dtype}")
        tensors.append(rel_base)
    dev = ts_nb.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"inputs on {dev} and {t.device}")


def _scalar(rel_base) -> int:
    """A scalar rel_base (int or 0-d tensor) as a Python int32 value."""
    v = int(rel_base.item() if isinstance(rel_base, torch.Tensor)
            else rel_base)
    return ((v + 2**31) & _M32) - 2**31


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the int32 tensor of the same bits."""
    return (((x + 2**31) & _M32) - 2**31).to(torch.int32)


def _varbytes_plain(pay: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    """[P] uint32 words (in int64) from a packed payload: nb significant
    big-endian bytes a value (the JAX package's _varbytes_u32)."""
    nb = nb.to(torch.int64)
    off = _as_i32(torch.cumsum(nb, 0) - nb).to(torch.int64)
    out = torch.zeros_like(nb)
    limit = pay.shape[0] - 1 if pay.shape[0] else 0
    for j in range(4):
        m = j < nb
        idx = torch.clamp(_as_i32(off + j).to(torch.int64), 0, limit)
        byte = (pay[idx].to(torch.int64) if pay.shape[0]
                else torch.zeros_like(nb))
        shift = torch.where(m, nb - 1 - j, 0) * 8
        word = torch.where((shift >= 0) & (shift < 32),
                           (byte << shift.clamp(0, 31)) & _M32, 0)
        out = out | torch.where(m, word, 0)
    return out


def _unzigzag_plain(z: torch.Tensor) -> torch.Tensor:
    return ((z >> 1) ^ (-(z & 1))) & _M32


def _seg_cumsum_plain(x: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """c[i] - c[first[i] - 1] mod 2^32 (the JAX int32 wraparound)."""
    c = torch.cumsum(x, 0)
    cp = torch.cat([torch.zeros(1, dtype=c.dtype, device=c.device), c])
    idx = torch.clamp(first.to(torch.int64), 0, x.shape[0])
    return (c - cp[idx]) & _M32


def _xor_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive XOR scan (Hillis-Steele; torch has no cumulative XOR)."""
    out = x.clone()
    d = 1
    while d < out.shape[0]:
        out[d:] = out[d:] ^ out[:-d].clone()
        d *= 2
    return out


def decode_points_plain(ts_nb, ts_pay, v_nb, v_pay, first_idx, blk_first,
                        rel_base, *, vkind: str = "f32"):
    """Plain PyTorch ``decode_points``: the JAX formulation, in int64
    words reduced mod 2^32. Returns (rel_ts int32 [P], vals float32
    [P])."""
    _check(ts_nb, ts_pay, v_nb, v_pay, first_idx, blk_first, rel_base,
           vkind)
    ent = _unzigzag_plain(_varbytes_plain(ts_pay, ts_nb))
    steps = _seg_cumsum_plain(ent, first_idx)
    deltas = _seg_cumsum_plain(steps, first_idx)
    if isinstance(rel_base, torch.Tensor) and rel_base.dim() == 1:
        base = rel_base.to(torch.int64)
    else:
        base = _scalar(rel_base)
    rel_ts = _as_i32(deltas + base)
    x = _varbytes_plain(v_pay, v_nb)
    if vkind == "int":
        vals = _as_i32(_seg_cumsum_plain(_unzigzag_plain(x),
                                         blk_first)).to(torch.float32)
    else:
        X = _xor_scan_plain(x)
        Xp = torch.cat([torch.zeros(1, dtype=X.dtype, device=X.device), X])
        bits = X ^ Xp[torch.clamp(blk_first.to(torch.int64), 0,
                                  x.shape[0])]
        vals = _as_i32(bits).view(torch.float32)
    return rel_ts, vals


def _status_words(lib: ctypes.CDLL, dev: torch.device, stream: int,
                  n: int) -> tuple[torch.Tensor, int]:
    """The status words of (card, stream) for n points, and this call's
    tag (1 .. 2^31 - 1). A buffer grows by a new zeroed one, enqueued on
    the stream ahead of the launch."""
    words = lib.block_decode_state_words(n)
    with _state_lock:
        buf = _state.get((dev.index, stream))
        if buf is None or buf.numel() < words:
            buf = _state[(dev.index, stream)] = torch.zeros(
                words, dtype=torch.int64, device=dev)
        return buf, next(_tags) % (2**31 - 1) + 1


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous and 16-byte aligned (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(fn, dev: int, *args) -> None:
    """Launch on the current stream of card ``dev``, entering the device
    guard only when ``dev`` is not the thread's current card (its enter
    and exit cost about as much host time as a launch)."""
    if dev == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def decode_points(ts_nb, ts_pay, v_nb, v_pay, first_idx, blk_first,
                  rel_base, *, vkind: str = "f32"):
    """(rel_ts int32 [P], vals float32 [P]) for a concatenated point
    stream; see the module docstring."""
    if ts_nb.device.type == "cpu":
        return decode_points_plain(ts_nb, ts_pay, v_nb, v_pay, first_idx,
                                   blk_first, rel_base, vkind=vkind)
    _check(ts_nb, ts_pay, v_nb, v_pay, first_idx, blk_first, rel_base,
           vkind)
    if ts_nb.device.type != "cuda":
        raise ValueError(f"no kernel for device {ts_nb.device}")
    dev = ts_nb.device
    n = ts_nb.shape[0]
    if n >= 2**31 - 2**12:
        raise ValueError(f"{n} points: the kernel indexes points in int32")
    lib = _kernels()
    rel_ts = torch.empty(n, dtype=torch.int32, device=dev)
    vals = torch.empty(n, dtype=torch.float32, device=dev)
    # Every input bound to a name until the launch is enqueued: a
    # temporary's block could otherwise go back to the allocator and
    # into the next temporary.
    ts_nb, v_nb, first_idx, blk_first = (
        _aligned(t) for t in (ts_nb, v_nb, first_idx, blk_first))
    ts_pay, v_pay = ts_pay.contiguous(), v_pay.contiguous()
    if isinstance(rel_base, torch.Tensor) and rel_base.dim() == 1:
        base_t, base_scalar = _aligned(rel_base), 0
        base_ptr = base_t.data_ptr()
    else:
        base_ptr, base_scalar = None, _scalar(rel_base)
    scratch = torch.empty(lib.block_decode_scratch_words(n),
                          dtype=torch.int32, device=dev)
    state, tag = _status_words(
        lib, dev, torch._C._cuda_getCurrentRawStream(dev.index), n)
    _launch(lib.block_decode_points, dev.index, ts_nb.data_ptr(),
            ts_pay.data_ptr(), ts_pay.shape[0], v_nb.data_ptr(),
            v_pay.data_ptr(), v_pay.shape[0], first_idx.data_ptr(),
            blk_first.data_ptr(), base_ptr, base_scalar,
            1 if vkind == "int" else 0, n, state.data_ptr(), tag,
            scratch.data_ptr(), rel_ts.data_ptr(), vals.data_ptr())
    decode_points.launches += 1
    return rel_ts, vals


decode_points.launches = 0
