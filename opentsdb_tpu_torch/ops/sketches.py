"""Mergeable sketches: t-digest percentiles and HyperLogLog counts, with
the CUDA kernels of ``csrc/sketches.cu`` and their plain PyTorch versions.

Mirrors ``opentsdb_tpu/ops/sketches.py`` of the JAX package: a t-digest is
a fixed-size pair (means[K], weights[K]); an HLL is registers[2^p] int32.
Folding a batch into a digest concatenates centroids and values, sorts
once, assigns each entry a k1 cluster from its cumulative weight,
k = delta/pi * asin(2q - 1) + delta/2, and sums weight and mean x weight
per cluster; an HLL fold is a max of leading-zero ranks per register.

The one-digest functions mirror the JAX functions of the same names:
``_compress``, ``tdigest_quantile`` and ``hash32`` are plain PyTorch on
any device; ``tdigest_add``, ``tdigest_merge`` and ``hll_add`` go through
the batched wrappers with one row. The batched wrappers are what the
live-sketch stacks (``stats/livesketch.py``) call, one launch each on a
CUDA tensor:

- ``tdigest_fold``: fold one batch row into each of R digest rows of a
  stack, in place (``_fold_tdigests`` and ``tdigest_merge``);
- ``hll_fold``: fold one row of items into each of H register rows of a
  stack, in place (``_fold_hlls``; ``distinct_tagv``'s one-row fold);
- ``hll_estimate``: the cardinality estimate of each register row;
- ``merged_quantile``: compress S selected digest rows into one digest
  and interpolate quantiles in it (``_merged_quantile``);
  ``merged_digest`` returns that digest instead, for tests.

Each wrapper takes its plain version only for tensors that lie on the
CPU; for CUDA tensors it launches its kernel on the calling thread's
current stream or raises. ``launches`` on each wrapper counts kernel
launches and nothing else. The source file says what each kernel
replaces, what bounds it and what its design does about that.

Parity with XLA. ``jnp.argsort`` is stable and its comparator treats -0.0
and +0.0 as equal and puts NaN (of either sign) after +inf. The sorts
here order by a composite int64 key: the order-preserving image of the
float key (zeros and NaNs canonicalised) in the high 32 bits, the
entry's index in the low 32, so both versions reproduce that order
exactly. (The kernels drop the entries of weight +-0 first, which changes
no bit of the answer, and sort the 32-bit image stably: the same order.)
Cumulative weights are sums of integer-valued float32 weights, exact
below 2^24 in any order. The cluster arithmetic is the JAX
expression's, operation by operation in float32; only ``asin`` differs
(XLA's, PyTorch's and CUDA's each within ~2 ulp), which can move an
entry whose k lies within a few ulps of an integer to the next cluster.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opentsdb_tpu_torch.ops import cuda_build
from opentsdb_tpu_torch.utils.config import resolve_device

DEFAULT_COMPRESSION = 128  # max centroids (delta)
DEFAULT_HLL_P = 14         # 2^14 registers -> ~0.8% standard error

# The JAX expression's float32 constants.
_Q_LO = np.float32(1e-7)
_Q_HI = np.float32(1 - 1e-7)
_TINY = np.float32(1e-30)


def _k_scale(compression: int) -> np.float32:
    """delta / pi, rounded as float32(delta) / float32(pi)."""
    return np.float32(compression) / np.float32(np.pi)


# ---------------------------------------------------------------------------
# Sort keys
# ---------------------------------------------------------------------------

def _sort_keys(keyf: torch.Tensor) -> torch.Tensor:
    """Composite int64 keys along the last axis of float32 ``keyf``: the
    order ``jnp.argsort`` gives (stable; -0.0 == +0.0; NaN after +inf),
    as distinct keys, so any sort reproduces it."""
    bits = keyf.contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    ordk = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF,
                       bits | 0x80000000)
    ordk = torch.where(keyf == 0, torch.full_like(ordk, 0x80000000), ordk)
    ordk = torch.where(torch.isnan(keyf),
                       torch.full_like(ordk, 0xFFC00000), ordk)
    idx = torch.arange(keyf.shape[-1], dtype=torch.int64,
                       device=keyf.device)
    return (ordk - (1 << 31)) * (1 << 32) + idx


def _digest_order(means: torch.Tensor, weights: torch.Tensor):
    """argsort of where(weights > 0, means, +inf) along the last axis."""
    keyf = torch.where(weights > 0, means,
                       torch.full_like(means, float("inf")))
    return torch.argsort(_sort_keys(keyf), dim=-1)


# ---------------------------------------------------------------------------
# t-digest: plain versions
# ---------------------------------------------------------------------------

def tdigest_init(compression: int = DEFAULT_COMPRESSION,
                 device: str | torch.device = "cuda"):
    """Empty digest state: (means[K], weights[K]) with zero weights."""
    device = resolve_device(device)
    return (torch.zeros(compression, dtype=torch.float32, device=device),
            torch.zeros(compression, dtype=torch.float32, device=device))


def _compress_rows(means: torch.Tensor, weights: torch.Tensor,
                   compression: int):
    """``_compress`` of each row of [R, N] float32 (means, weights) into
    [R, compression] (means, weights): the plain version of the fold's
    and the merged quantile's compress."""
    order = _digest_order(means, weights)
    m = means.gather(-1, order)
    w = weights.gather(-1, order)
    total = torch.clamp(w.sum(-1, keepdim=True), min=float(_TINY))
    cum = torch.cumsum(w, -1)
    q = (cum - w / 2) / total
    q = torch.clamp(q, min=float(_Q_LO), max=float(_Q_HI))
    k = torch.asin(2 * q - 1) * torch.tensor(_k_scale(compression),
                                             device=q.device) \
        + np.float32(compression / 2)
    cl = torch.clamp(k.to(torch.int32), 0, compression - 1).to(torch.int64)
    cl = torch.where(w > 0, cl, torch.full_like(cl, compression))
    shape = (*w.shape[:-1], compression + 1)
    wsum = torch.zeros(shape, dtype=torch.float32, device=w.device) \
        .scatter_add_(-1, cl, w)[..., :compression]
    msum = torch.zeros(shape, dtype=torch.float32, device=w.device) \
        .scatter_add_(-1, cl, m * w)[..., :compression]
    new_means = torch.where(wsum > 0,
                            msum / torch.clamp(wsum, min=float(_TINY)),
                            torch.zeros_like(msum))
    return new_means, wsum


def _compress(means: torch.Tensor, weights: torch.Tensor, *,
              compression: int):
    """Sort centroids and merge them into <= compression clusters
    (``opentsdb_tpu/ops/sketches.py:52``); plain version, 1-D."""
    m, w = _compress_rows(means[None], weights[None], compression)
    return m[0], w[0]


def tdigest_add(means: torch.Tensor, weights: torch.Tensor,
                values: torch.Tensor, valid: torch.Tensor, *,
                compression: int = DEFAULT_COMPRESSION):
    """Fold a batch of values (with padding mask) into one digest."""
    m = means[None].clone()
    w = weights[None].clone()
    tdigest_fold(m, w, torch.zeros(1, dtype=torch.int32, device=m.device),
                 values.to(torch.float32)[None], valid=valid[None],
                 compression=compression)
    return m[0], w[0]


def tdigest_merge(means_a, weights_a, means_b, weights_b, *,
                  compression: int = DEFAULT_COMPRESSION):
    """Merge two digests: concatenate and compress."""
    m = means_a[None].clone()
    w = weights_a[None].clone()
    tdigest_fold(m, w, torch.zeros(1, dtype=torch.int32, device=m.device),
                 means_b[None], batch_weights=weights_b[None],
                 compression=compression)
    return m[0], w[0]


def tdigest_quantile(means: torch.Tensor, weights: torch.Tensor, q):
    """Quantiles q (in [0, 1]) of one digest, interpolated between
    centroid centres; empty slots excluded (``ops/sketches.py:110``).
    Plain version (the live sketches run it inside ``merged_quantile``'s
    kernel)."""
    q = torch.atleast_1d(torch.as_tensor(q, dtype=torch.float32,
                                         device=means.device))
    order = _digest_order(means, weights)
    m = means[order]
    w = weights[order]
    nreal = max(int((weights > 0).sum()), 1)
    last = nreal - 1
    total = torch.clamp(w.sum(), min=float(_TINY))
    cum = torch.cumsum(w, 0)
    centers = (cum - w / 2) / total
    centers = torch.where(torch.arange(len(m), device=m.device) < nreal,
                          centers,
                          torch.full_like(centers, float("inf")))
    target = torch.clamp(q, 0.0, 1.0)
    idx = torch.searchsorted(centers, target)
    lo = torch.clamp(idx - 1, 0, last)
    hi = torch.clamp(idx, 0, last)
    c0, c1 = centers[lo], centers[hi]
    m0, m1 = m[lo], m[hi]
    frac = torch.where(c1 > c0,
                       (target - c0) / torch.clamp(c1 - c0,
                                                   min=float(_TINY)),
                       torch.zeros_like(c0))
    frac = torch.clamp(frac, 0.0, 1.0)
    est = m0 + frac * (m1 - m0)
    est = torch.where(target <= centers[0], m[0], est)
    est = torch.where(target >= centers[last], m[last], est)
    return est


def tdigest_count(weights: torch.Tensor) -> torch.Tensor:
    return weights.sum()


# ---------------------------------------------------------------------------
# HyperLogLog: plain versions
# ---------------------------------------------------------------------------

def hll_init(p: int = DEFAULT_HLL_P, device: str | torch.device = "cuda"):
    return torch.zeros(1 << p, dtype=torch.int32,
                       device=resolve_device(device))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h, c < 2^32 in int64, without overflow."""
    return (h * (c & 0xFFFF) + ((h * (c >> 16)) << 16)) & 0xFFFFFFFF


def hash32(x: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche mixer (murmur3 finalizer) over int32 input; the
    uint32 result is held in int64."""
    h = x.to(torch.int64) & 0xFFFFFFFF
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _hll_ranks(items: torch.Tensor, valid: torch.Tensor, p: int):
    """(register index, rank) of each item; invalid items index the trash
    register 2^p. rank = leading zeros of the low 32-p bits + 1, taken
    as the JAX package does from the float32 exponent of those bits."""
    h = hash32(items)
    idx = h >> (32 - p)
    w = h & ((1 << (32 - p)) - 1)
    lg = torch.frexp(w.to(torch.float32))[1].to(torch.int64) - 1
    rank = torch.where(w > 0, (32 - p) - lg,
                       torch.full_like(lg, 32 - p + 1))
    idx = torch.where(valid, idx, torch.full_like(idx, 1 << p))
    return idx, rank.to(torch.int32)


def hll_add(registers: torch.Tensor, items: torch.Tensor,
            valid: torch.Tensor, *, p: int = DEFAULT_HLL_P):
    """Fold hashed items (e.g. tag-value UIDs as int32) into one register
    row."""
    regs = registers[None].clone()
    hll_fold(regs, torch.zeros(1, dtype=torch.int32, device=regs.device),
             items.to(torch.int32)[None], valid[None], p=p)
    return regs[0]


def hll_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("sketches")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.tdigest_fold_f32.argtypes = [p, p, i64, i32, p, i64, p, p, p,
                                         i32, p]
        lib.hll_fold_i32.argtypes = [p, i64, i32, p, i64, p, p, i32, p]
        lib.hll_estimate_f32.argtypes = [p, i64, i32, p, p]
        lib.empty_launch.argtypes = [p]
        lib.tdigest_merged_quantile_f32.argtypes = [
            p, p, i32, p, p, i64, p, i32, i32, p, i64, p, p]
        lib.tdigest_merged_quantile_scratch.argtypes = [i64, i32]
        lib.tdigest_merged_quantile_scratch.restype = i64
        lib.tdigest_merged_digest_f32.argtypes = [
            p, p, i32, p, p, i64, i32, p, i64, p, p]
        for fn in (lib.tdigest_fold_f32, lib.hll_fold_i32,
                   lib.hll_estimate_f32, lib.tdigest_merged_quantile_f32,
                   lib.tdigest_merged_digest_f32, lib.empty_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(fn, dev: int, *args) -> None:
    """Launch ``fn`` on the current stream of card ``dev``. The device
    guard is entered only when ``dev`` is not the thread's current card:
    its enter and exit cost about as much host time as the launch."""
    if dev == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def empty_launch(dev: int) -> None:
    """Launch an empty kernel on card ``dev`` the way the wrappers launch
    theirs: the launch floor, for measurements. Not counted."""
    _launch(_kernels().empty_launch, dev)


def _check_stack(means, weights, idx, what):
    if means.dim() != 2 or means.dtype != torch.float32 \
            or weights.shape != means.shape \
            or weights.dtype != torch.float32:
        raise ValueError(f"{what}: means and weights must be one [C, K] "
                         f"float32 shape, got {tuple(means.shape)} "
                         f"{means.dtype}, {tuple(weights.shape)} "
                         f"{weights.dtype}")
    if not (means.is_contiguous() and weights.is_contiguous()):
        raise ValueError(f"{what}: the stacks must be contiguous")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"{what}: idx must be [R] int32")
    for t in (weights, idx):
        if t.device != means.device:
            raise ValueError(f"{what}: tensors on {means.device} and "
                             f"{t.device}")


# Largest K + P the fold kernel sorts in one block's shared memory.
FOLD_MAX_ENTRIES = 8192


def tdigest_fold_plain(means, weights, idx, batch, valid=None,
                       weights_b=None, *, compression: int) -> None:
    """Plain ``tdigest_fold``."""
    C = means.shape[0]
    keep = (idx >= 0) & (idx < C)
    rows = idx[keep].long()
    bw = (valid[keep].to(torch.float32) if weights_b is None
          else weights_b[keep])
    m = torch.cat([means[rows], batch[keep]], 1)
    w = torch.cat([weights[rows], bw], 1)
    nm, nw = _compress_rows(m, w, compression)
    means[rows] = nm
    weights[rows] = nw


def tdigest_fold(means: torch.Tensor, weights: torch.Tensor,
                 idx: torch.Tensor, batch: torch.Tensor,
                 valid: torch.Tensor | None = None,
                 batch_weights: torch.Tensor | None = None, *,
                 compression: int) -> None:
    """Fold row r of the [R, P] float32 ``batch`` into digest row idx[r]
    of the [C, K] stacks, in place (the JAX package returns new arrays;
    the stacks here are updated where they lie). Each batch entry weighs
    ``valid`` (bool, 1 or 0) or ``batch_weights`` (float32, a digest's
    centroid weights: ``tdigest_merge``). Rows with idx outside [0, C)
    are skipped; the idx of a call must be distinct."""
    _check_stack(means, weights, idx, "tdigest_fold")
    if means.shape[1] != compression:
        raise ValueError(f"tdigest_fold: stacks hold {means.shape[1]} "
                         f"centroids a row, compression is {compression}")
    R = idx.shape[0]
    if batch.dim() != 2 or batch.dtype != torch.float32 \
            or batch.shape[0] != R:
        raise ValueError(f"tdigest_fold: batch must be [R, P] float32, "
                         f"got {tuple(batch.shape)} {batch.dtype}")
    if (valid is None) == (batch_weights is None):
        raise ValueError("tdigest_fold: pass exactly one of valid and "
                         "batch_weights")
    mask = valid if valid is not None else batch_weights
    want = torch.bool if valid is not None else torch.float32
    if mask.shape != batch.shape or mask.dtype != want:
        raise ValueError(f"tdigest_fold: weights of the batch must be "
                         f"{tuple(batch.shape)} {want}")
    if means.device.type == "cpu":
        tdigest_fold_plain(means, weights, idx, batch, valid,
                           batch_weights, compression=compression)
        return
    if means.device.type != "cuda":
        raise ValueError(f"no kernel for device {means.device}")
    K, P = means.shape[1], batch.shape[1]
    if K + P > FOLD_MAX_ENTRIES:
        raise ValueError(f"tdigest_fold: K + P = {K + P} entries a row, "
                         f"the kernel sorts at most {FOLD_MAX_ENTRIES}")
    if R == 0:
        return
    batch = batch.contiguous()
    mask = mask.contiguous()
    _launch(_kernels().tdigest_fold_f32, means.get_device(),
            means.data_ptr(), weights.data_ptr(), means.shape[0], K,
            idx.contiguous().data_ptr(), R, batch.data_ptr(),
            mask.data_ptr() if valid is not None else None,
            mask.data_ptr() if batch_weights is not None else None, P)
    tdigest_fold.launches += 1


tdigest_fold.launches = 0


def hll_fold_plain(regs, idx, items, valid, *, p: int) -> None:
    """Plain ``hll_fold``: one ``scatter_reduce_`` (amax) of every valid
    item's rank into the flattened stack, so a slot that several rows
    name takes the max over all of them. Items of skipped rows and
    invalid items carry rank 0, which raises no register."""
    C, m = regs.shape[0], 1 << p
    if C == 0 or items.numel() == 0:
        return
    keep = (idx >= 0) & (idx < C)
    reg, rank = _hll_ranks(items, valid & keep[:, None], p)
    live = reg < m
    flat = idx.long().clamp(0, C - 1)[:, None] * m + reg
    regs.view(-1).scatter_reduce_(
        0, torch.where(live, flat, 0).reshape(-1),
        torch.where(live, rank, 0).reshape(-1), "amax")


def hll_fold(regs: torch.Tensor, idx: torch.Tensor, items: torch.Tensor,
             valid: torch.Tensor, *, p: int) -> None:
    """Fold row r of the [H, U] int32 ``items`` (``valid`` its mask) into
    register row idx[r] of the [C, 2^p] int32 stack, in place: register
    = max(register, rank) over the items hashed to it. A slot that
    several rows name takes the max over all of their items, as
    ``_fold_hlls``' ``.at[idx].max`` does. Rows with idx outside [0, C)
    are skipped, negative ones included (where the JAX function wraps a
    negative idx: ROADMAP.md queue C, reference note 7)."""
    # The checks read each attribute once, and the device type through
    # is_cpu / is_cuda: on a card the whole call is host time.
    if regs.dtype != torch.int32 or regs.dim() != 2 \
            or regs.shape[1] != 1 << p or not regs.is_contiguous():
        raise ValueError(f"hll_fold: registers must be a contiguous "
                         f"[C, {1 << p}] int32 stack, got "
                         f"{tuple(regs.shape)} {regs.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("hll_fold: idx must be [H] int32")
    H = idx.shape[0]
    shape = items.shape
    if items.dtype != torch.int32 or len(shape) != 2 or shape[0] != H \
            or valid.dtype != torch.bool or valid.shape != shape:
        raise ValueError("hll_fold: items must be [H, U] int32 with a "
                         "bool mask of the same shape")
    dev = regs.device
    if idx.device != dev or items.device != dev or valid.device != dev:
        other = next(t.device for t in (idx, items, valid)
                     if t.device != dev)
        raise ValueError(f"hll_fold: tensors on {dev} and {other}")
    if not 4 <= p <= 18:
        raise ValueError(f"hll_fold: p must be in [4, 18], got {p}")
    if regs.is_cpu:
        hll_fold_plain(regs, idx, items, valid, p=p)
        return
    if not regs.is_cuda:
        raise ValueError(f"no kernel for device {dev}")
    if H == 0:
        return
    _launch(_kernels().hll_fold_i32, dev.index, regs.data_ptr(),
            regs.shape[0], p, idx.contiguous().data_ptr(), H,
            items.contiguous().data_ptr(), valid.contiguous().data_ptr(),
            shape[1])
    hll_fold.launches += 1


hll_fold.launches = 0


def hll_estimate_plain(registers: torch.Tensor) -> torch.Tensor:
    """Plain ``hll_estimate`` over the last axis. The sum of 2^-r is the
    kernel's: exact in int64 as 2^(33 - r) for r in [0, 33] (every
    register a fold writes), rounded to float32 once and scaled by 2^-33;
    any other register adds 2^-r in float32. The JAX function sums the
    float32 terms, which can land an ulp away from the exact sum."""
    m = registers.shape[-1]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    r = registers.to(torch.int64)
    fits = (r >= 0) & (r <= 33)
    exact = torch.where(fits, torch.ones_like(r) << (33 - r.clamp(0, 33)),
                        0).sum(-1)
    rest = torch.where(fits, 0.0, torch.exp2(-registers.to(torch.float32)))
    inv = exact.to(torch.float32) * np.float32(2.0 ** -33) + rest.sum(-1)
    raw = torch.tensor(np.float32(alpha * m * m),
                       device=registers.device) / inv
    zeros = (registers == 0).sum(-1).to(torch.float32)
    small = np.float32(m) * torch.log(
        np.float32(m) / torch.clamp(zeros, min=1.0))
    est = torch.where((raw <= np.float32(2.5 * m)) & (zeros > 0), small,
                      raw)
    two32 = np.float32(2.0) ** 32
    return torch.where(est > two32 / np.float32(30.0),
                       -two32 * torch.log1p(-est / two32), est)


def hll_estimate(registers: torch.Tensor) -> torch.Tensor:
    """Cardinality estimate with small- and large-range corrections, of
    one [2^p] register row (a scalar) or of each row of [H, 2^p] ([H]),
    float32."""
    nd = registers.dim()
    if registers.dtype != torch.int32 or nd not in (1, 2):
        raise ValueError(f"hll_estimate: registers must be [2^p] or "
                         f"[H, 2^p] int32, got {tuple(registers.shape)} "
                         f"{registers.dtype}")
    m = registers.shape[-1]
    if m < 16 or m & (m - 1):
        raise ValueError(f"hll_estimate: {m} registers a row is not 2^p")
    if registers.is_cpu:
        return hll_estimate_plain(registers)
    if not registers.is_cuda:
        raise ValueError(f"no kernel for device {registers.device}")
    rows = (registers if nd == 2 else registers[None]).contiguous()
    if rows.data_ptr() % 16:  # the kernel loads 16 bytes at a time
        rows = rows.clone()
    R = rows.shape[0]
    out = torch.empty(R, dtype=torch.float32, device=rows.device)
    if R:
        _launch(_kernels().hll_estimate_f32, rows.get_device(),
                rows.data_ptr(), R, m, out.data_ptr())
        hll_estimate.launches += 1
    return out if nd == 2 else out[0]


hll_estimate.launches = 0


def _check_merged(means, weights, idx, valid, compression, what):
    _check_stack(means, weights, idx, what)
    if valid.shape != idx.shape or valid.dtype != torch.bool \
            or valid.device != means.device:
        raise ValueError(f"{what}: valid must be a bool mask of "
                         "idx's shape, on the stacks' device")
    if means.shape[1] != compression:
        raise ValueError(f"{what}: stacks hold {means.shape[1]} "
                         f"centroids a row, compression is {compression}")


def _merged_scratch(lib, means, S, compression) -> torch.Tensor:
    n = S * means.shape[1]
    return torch.empty(
        int(lib.tdigest_merged_quantile_scratch(n, compression)),
        dtype=torch.uint8, device=means.device)


def merged_quantile_plain(means, weights, idx, valid, q, *,
                          compression: int) -> torch.Tensor:
    """Plain ``merged_quantile``."""
    mm, ww = merged_digest_plain(means, weights, idx, valid,
                                 compression=compression)
    return tdigest_quantile(mm, ww, q)


def merged_quantile(means: torch.Tensor, weights: torch.Tensor,
                    idx: torch.Tensor, valid: torch.Tensor,
                    q: torch.Tensor, *, compression: int) -> torch.Tensor:
    """Quantiles ``q`` ([Q] float32, on the stacks' device) of the merged
    distribution of digest rows idx[valid]: the S x K selected centroids
    (rows where valid is False weigh 0) compressed into one digest of
    ``compression`` centroids, then interpolated; [Q] float32."""
    _check_merged(means, weights, idx, valid, compression,
                  "merged_quantile")
    if q.dim() != 1 or q.dtype != torch.float32 \
            or q.device != means.device:
        raise ValueError("merged_quantile: q must be [Q] float32 on the "
                         "stacks' device")
    if means.device.type == "cpu":
        return merged_quantile_plain(means, weights, idx, valid, q,
                                     compression=compression)
    if means.device.type != "cuda":
        raise ValueError(f"no kernel for device {means.device}")
    lib = _kernels()
    S, K = idx.shape[0], means.shape[1]
    scratch = _merged_scratch(lib, means, S, compression)
    out = torch.empty(q.shape[0], dtype=torch.float32, device=means.device)
    _launch(lib.tdigest_merged_quantile_f32, means.get_device(),
            means.data_ptr(), weights.data_ptr(), K,
            idx.contiguous().data_ptr(), valid.contiguous().data_ptr(), S,
            q.contiguous().data_ptr(), q.shape[0], compression,
            scratch.data_ptr(), scratch.numel(), out.data_ptr())
    merged_quantile.launches += 1
    return out


merged_quantile.launches = 0


def merged_digest_plain(means, weights, idx, valid, *, compression: int):
    """Plain ``merged_digest``."""
    m = torch.where(valid[:, None], means[idx.long()],
                    torch.zeros((), device=means.device)).reshape(-1)
    w = torch.where(valid[:, None], weights[idx.long()],
                    torch.zeros((), device=means.device)).reshape(-1)
    mm, ww = _compress_rows(m[None], w[None], compression)
    return mm[0], ww[0]


def merged_digest(means: torch.Tensor, weights: torch.Tensor,
                  idx: torch.Tensor, valid: torch.Tensor, *,
                  compression: int):
    """The merged digest ``merged_quantile`` interpolates in: (means,
    weights), [compression] float32 each, computed by the same kernel
    launches. For tests: it lets them hold the merged digest's weights
    exactly against the plain compress. Launches are not counted."""
    _check_merged(means, weights, idx, valid, compression, "merged_digest")
    if means.device.type == "cpu":
        return merged_digest_plain(means, weights, idx, valid,
                                   compression=compression)
    if means.device.type != "cuda":
        raise ValueError(f"no kernel for device {means.device}")
    lib = _kernels()
    S, K = idx.shape[0], means.shape[1]
    scratch = _merged_scratch(lib, means, S, compression)
    out = torch.empty((2, compression), dtype=torch.float32,
                      device=means.device)
    _launch(lib.tdigest_merged_digest_f32, means.get_device(),
            means.data_ptr(), weights.data_ptr(), K,
            idx.contiguous().data_ptr(), valid.contiguous().data_ptr(), S,
            compression, scratch.data_ptr(), scratch.numel(),
            out.data_ptr())
    return out[0], out[1]


# ---------------------------------------------------------------------------
# Numpy oracles (for tests)
# ---------------------------------------------------------------------------

def exact_quantile(values: np.ndarray, q: float) -> float:
    return float(np.quantile(np.asarray(values, dtype=np.float64), q))


def exact_distinct(values: np.ndarray) -> int:
    return int(len(np.unique(values)))

