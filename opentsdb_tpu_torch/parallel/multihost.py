"""Multi-host scale-out: hybrid host x series meshes and two-level merges.

Mirrors ``opentsdb_tpu/parallel/multihost.py``. The hybrid mesh has two
axes (``parallel/mesh.py``):

- ``series`` (inner): the cards (or logical shards) of one host. Per
  bucket partial moments, HLL registers and t-digest centroids merge here
  first.
- ``host`` (outer): across hosts. Only the already-reduced partials
  cross this axis ([B]-bucket moment rows, HLL registers, compressed
  digests), never points.

In one process the host rows are folds of one device list (the CPU
tests, four logical shards of one card folded 2 x 2). Across processes,
each process of a mesh plane (``parallel/fleet.py``) holds one host row
and the host-axis merges travel ``torch.distributed``
(``parallel/compile.py``); the bodies are the same.

Moments merge exactly (Chan et al.'s pairwise update at each level) in
the hand-written ``hybrid_moment_combine`` kernel
(``ops/mesh_combine.py``): in one launch over the whole [H, C] mesh in
one process; across processes each process emits its row's partials
(the kernel's first level), the rows are all-gathered, and a second
launch finishes over [H, 1], which gives the same bits. HLL registers
merge by elementwise max, row then hosts, and the estimate is the
``hll_estimate`` kernel's; t-digests recompress at each level through
the ``tdigest_fold`` kernel (one row a digest, centroid weights as
batch weights), so the host digests that cross are
O(compression) whatever the point count.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from opentsdb_tpu_torch.core.const import NOLERP_AGGS
from opentsdb_tpu_torch.ops import mesh_combine, sketches
from opentsdb_tpu_torch.parallel.compile import (combine,
                                                 compile_with_plan, pmax)
from opentsdb_tpu_torch.parallel.mesh import (HOST_AXIS, SERIES_AXIS,
                                              Mesh, local_devices)
from opentsdb_tpu_torch.parallel.plan import ExecPlan
from opentsdb_tpu_torch.parallel.sharded import _local_group_moments


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, **kw) -> bool:
    """Join a multi-process mesh plane (one process per host).

    A thin wrapper over ``fleet.init_plane``; the arguments default to
    torch.distributed's environment variables (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). Returns True when this
    process is one of several after the call. A no-op returning False
    when nothing asks for several processes, so single-host entry points
    can call it unconditionally; True again once a plane of several is
    joined."""
    from opentsdb_tpu_torch.parallel import fleet

    env = os.environ
    if coordinator_address is None and num_processes is None \
            and "MASTER_ADDR" not in env:
        return fleet.plane() is not None
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', '')}:"
                               f"{env.get('MASTER_PORT', '')}")
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    fleet.init_plane(coordinator_address, num_processes, process_id, **kw)
    return fleet.plane() is not None


def make_hybrid_mesh(n_hosts: int | None = None,
                     chips_per_host: int | None = None,
                     devices=None) -> Mesh:
    """2-D (host, series) mesh: inner axis a host's cards, outer axis the
    hosts.

    In a mesh plane of several processes, each process is one host row:
    ``devices`` (default: this process's cards) are its chips, and the
    mesh's host axis spans the plane's processes. In one process the
    flat device list (a device may repeat) folds into [n_hosts,
    chips_per_host] to run the same collective program."""
    from opentsdb_tpu_torch.parallel import fleet

    if devices is None:
        devices = local_devices()
    devices = list(devices)
    plane = fleet.plane()
    if plane is not None:
        if chips_per_host is None:
            chips_per_host = len(devices)
        if n_hosts is None:
            n_hosts = plane[1]
        if n_hosts != plane[1] or chips_per_host != len(devices):
            raise ValueError(
                f"{len(devices)} local devices x {plane[1]} processes "
                f"don't fold into {n_hosts} hosts x {chips_per_host} "
                f"chips")
        return Mesh(devices, (HOST_AXIS, SERIES_AXIS),
                    shape=(1, chips_per_host), plane=plane)
    if chips_per_host is None:
        chips_per_host = len(devices)
    if n_hosts is None:
        n_hosts = len(devices) // chips_per_host
    if n_hosts * chips_per_host != len(devices):
        raise ValueError(
            f"{len(devices)} devices don't fold into "
            f"{n_hosts} hosts x {chips_per_host} chips")
    return Mesh(devices, (HOST_AXIS, SERIES_AXIS),
                shape=(n_hosts, chips_per_host))


# ---------------------------------------------------------------------------
# Grouped downsample
# ---------------------------------------------------------------------------

def _partial_planes(payloads, dev, agg, rows: int):
    """The shards' partials stacked [rows, k, cells] on ``dev``: each
    payload is (agg, n, total, m2, mean, min, max, any)."""
    want = mesh_combine.hybrid_needs(agg)
    k = len(payloads) // rows

    def plane(i, name=None):
        if name is not None and name not in want:
            return None
        x = torch.stack([p[i].to(dev) for p in payloads])
        return x.reshape(rows, k, -1)

    any_ = torch.stack([p[7].to(dev).to(torch.int32) for p in payloads])
    return (plane(1, "n"), plane(2, "total"), plane(3, "m2"),
            plane(4, "mean"), plane(5, "min"), plane(6, "max"),
            any_.reshape(rows, k, -1))


def _hybrid_finish(payloads, dev):
    """Every shard's partials as [H, C, cells]: both levels and the
    aggregator in one launch."""
    agg = payloads[0][0]
    H = payloads[0][8]
    return mesh_combine.hybrid_moment_combine(
        *_partial_planes(payloads, dev, agg, H), agg=agg)


def _hybrid_emit(payloads, dev):
    """One host row's chips as [1, C, cells]: the first level, the row's
    partials [cells] each (what crosses the plane)."""
    agg = payloads[0][0]
    rows = mesh_combine.hybrid_moment_combine(
        *_partial_planes(payloads, dev, agg, 1), agg=agg, emit=True)
    return (agg,) + tuple(None if x is None else x[0] for x in rows)


def _hybrid_finish_rows(payloads, dev):
    """The rows' partials (one payload a row, in row order) as
    [H, 1, cells]: the second level and the aggregator."""
    agg = payloads[0][0]
    return mesh_combine.hybrid_moment_combine(
        *_partial_planes(payloads, dev, agg, len(payloads)), agg=agg)


def _hybrid_group_body(ts, vals, sid, valid, *, axis_index,
                       series_per_shard, num_buckets, interval, agg_down,
                       agg_group, hosts, two_level):
    n, total, m2, mean, mn, mx, any_real = _local_group_moments(
        ts, vals, sid, valid, num_series=series_per_shard,
        num_buckets=num_buckets, interval=interval, agg_down=agg_down,
        lerp=agg_group not in NOLERP_AGGS)
    if not two_level:
        out, g_any = yield combine(_hybrid_finish, agg_group, n, total,
                                   m2, mean, mn, mx, any_real, hosts)
        return out, g_any
    # Level 1 (a host's cards), then only the row's [B] partials cross.
    row = yield combine(_hybrid_emit, agg_group, n, total, m2, mean, mn,
                        mx, any_real, axis=SERIES_AXIS)
    out, g_any = yield combine(_hybrid_finish_rows, *row, axis=HOST_AXIS)
    return out, g_any


HYBRID_GROUP_PLAN = ExecPlan(
    name="multihost.downsample_group", axis="host", style="shard_map",
    in_specs=((HOST_AXIS, SERIES_AXIS),) * 4,
    out_specs=(None, None))


def hybrid_downsample_group(ts, vals, sid, valid, *, mesh,
                            series_per_shard: int, num_buckets: int,
                            interval: int, agg_down: str, agg_group: str):
    """Fused downsample + two-level group aggregation over a hybrid mesh.

    Args are [H*C, N_shard] stacked shards, host-major (``pack_shards(
    series, H * C)``), this process's rows of them on a mesh across
    processes; sid local to each shard. Moments combine exactly over a
    host's cards first, then the [B]-sized host partials over the hosts.
    Returns (group_values [B], group_mask [B]) on the mesh's first
    device. In one process the partials of every shard merge in one
    launch; on a mesh across processes each row's partials are emitted,
    gathered over the plane and finished, which gives the same bits."""
    fn = compile_with_plan(
        _hybrid_group_body, HYBRID_GROUP_PLAN, mesh,
        statics=(("series_per_shard", series_per_shard),
                 ("num_buckets", num_buckets), ("interval", interval),
                 ("agg_down", agg_down), ("agg_group", agg_group),
                 ("hosts", mesh.global_shape[0]),
                 ("two_level", mesh.plane is not None)))
    return fn(ts, vals, sid, valid)


# ---------------------------------------------------------------------------
# Sketches
# ---------------------------------------------------------------------------

def _hll_estimate_rows(payloads, dev):
    """Register max over the host rows, in row order, then the
    estimate."""
    regs = torch.stack([p[0].to(dev) for p in payloads]).amax(dim=0)
    return sketches.hll_estimate(regs)


def _hybrid_hll_body(items, valid, *, axis_index, p):
    regs = sketches.hll_init(p, device=items.device)
    regs = sketches.hll_add(regs, items, valid, p=p)
    host = yield pmax(regs, axis=SERIES_AXIS)
    return (yield combine(_hll_estimate_rows, host, axis=HOST_AXIS))


HYBRID_HLL_PLAN = ExecPlan(
    name="multihost.hll_distinct", axis="host", style="shard_map",
    in_specs=((HOST_AXIS, SERIES_AXIS),) * 2, out_specs=None)


def hybrid_hll_distinct(items, valid, *, mesh, p: int = 14):
    """Distinct count over [H*C, N_shard] shards: register max over a
    host's cards, then over the hosts; 2^p registers cross hosts,
    whatever the point count."""
    fn = compile_with_plan(_hybrid_hll_body, HYBRID_HLL_PLAN, mesh,
                           statics=(("p", p),))
    return fn(items, valid)


def _recompress(payloads, dev):
    """The gathered digests (one payload each: means, weights,
    compression) folded into one empty digest by the t-digest fold
    kernel, their centroid weights as the batch weights."""
    compression = payloads[0][2]
    means = torch.cat([p[0].to(dev) for p in payloads])[None]
    weights = torch.cat([p[1].to(dev) for p in payloads])[None]
    m, w = sketches.tdigest_init(compression, device=dev)
    m, w = m[None].clone(), w[None].clone()
    sketches.tdigest_fold(m, w, torch.zeros(1, dtype=torch.int32,
                                            device=dev),
                          means, batch_weights=weights,
                          compression=compression)
    return m[0], w[0]


def _tdigest_hosts(payloads, dev):
    """The hosts' digests recompressed, in row order; the quantiles."""
    m, w = _recompress(payloads, dev)
    return sketches.tdigest_quantile(m, w, list(payloads[0][3]))


def _shard_digest(values, valid, compression: int):
    """One shard's digest. Values that fit one row of the t-digest fold
    kernel (``FOLD_MAX_ENTRIES`` entries with the digest's own) fold as
    ``tdigest_add`` does, into one compress. Past that, rows of the
    values fold in one launch, one digest a row, and the row digests
    recompress in groups (their centroid weights as batch weights), one
    launch a level, down to one digest: the same bounded-error union as
    the mesh's own merges."""
    K = compression
    dev = values.device
    P = sketches.FOLD_MAX_ENTRIES - K
    n = values.shape[0]
    if n <= P:
        m, w = sketches.tdigest_init(K, device=dev)
        return sketches.tdigest_add(m, w, values, valid, compression=K)
    R = -(-n // P)
    vals = torch.zeros(R * P, dtype=torch.float32, device=dev)
    ok = torch.zeros(R * P, dtype=torch.bool, device=dev)
    vals[:n] = values
    ok[:n] = valid
    means = torch.zeros((R, K), dtype=torch.float32, device=dev)
    weights = torch.zeros((R, K), dtype=torch.float32, device=dev)
    sketches.tdigest_fold(means, weights,
                          torch.arange(R, dtype=torch.int32, device=dev),
                          vals.reshape(R, P), valid=ok.reshape(R, P),
                          compression=K)
    per = P // K
    while R > 1:
        G = -(-R // per)
        pad = G * per - R
        gm = torch.cat([means, means.new_zeros((pad, K))]).reshape(G, -1)
        gw = torch.cat([weights, weights.new_zeros((pad, K))]).reshape(G,
                                                                     -1)
        means = torch.zeros((G, K), dtype=torch.float32, device=dev)
        weights = torch.zeros((G, K), dtype=torch.float32, device=dev)
        sketches.tdigest_fold(means, weights,
                              torch.arange(G, dtype=torch.int32,
                                           device=dev),
                              gm, batch_weights=gw, compression=K)
        R = G
    return means[0], weights[0]


def _hybrid_tdigest_body(values, valid, qs, *, axis_index, compression):
    means, weights = _shard_digest(values, valid, compression)
    # A host's cards: gather the chip digests and recompress.
    hm, hw = yield combine(_recompress, means, weights, compression,
                           axis=SERIES_AXIS)
    # The hosts: gather only the compressed host digests.
    return (yield combine(_tdigest_hosts, hm, hw, compression, qs,
                          axis=HOST_AXIS))


HYBRID_TDIGEST_PLAN = ExecPlan(
    name="multihost.tdigest", axis="host", style="shard_map",
    in_specs=((HOST_AXIS, SERIES_AXIS),) * 2 + (None,), out_specs=None)


def hybrid_tdigest(values, valid, qs, *, mesh, compression: int = 128):
    """Quantiles over [H*C, N_shard] shards with a two-level digest
    merge: a host's chip digests gathered and recompressed to one host
    digest, then only the compressed host digests gathered over the
    hosts and recompressed; traffic over the hosts is O(hosts *
    compression), not O(chips * compression)."""
    q = tuple(float(x) for x in np.atleast_1d(np.asarray(qs, np.float32)))
    fn = compile_with_plan(_hybrid_tdigest_body, HYBRID_TDIGEST_PLAN,
                           mesh, statics=(("compression", compression),))
    return fn(values, valid, q)
