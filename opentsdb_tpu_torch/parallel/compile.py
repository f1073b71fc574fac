"""compile_with_plan: the one entry point for mesh execution.

Mirrors ``opentsdb_tpu/parallel/compile.py``. Every mesh body the query
and rollup paths run goes through

    fn = compile_with_plan(body, plan, mesh[, statics])

and ``fn`` is a dispatcher cached per (body, plan, mesh, statics), so
repeat dashboards never rebuild one. PyTorch runs eagerly, so there is
nothing to compile: the cache holds the dispatchers, and its counters
are the JAX plane's (``cache_info``).

- ``mesh is None``: the body with its statics bound, called as is (the
  single-device leg).
- mesh, ``plan.in_specs is None``: the same, timed as a mesh dispatch.
- mesh and specs: the body runs once per shard, shard i on
  ``mesh.devices[i]`` with its row of each input the specs split (the
  rest replicated), one shard after another on the calling thread.

Collectives. A mesh body is a generator: where the JAX body calls
``jax.lax.psum(x, axis)`` the port's body writes ``x = yield psum(x)``.
The dispatcher steps the shards' generators in lockstep; at each yield
it gathers every shard's payload onto the mesh's first device and runs
the collective's combine there once, in shard order, then hands each
shard its result (moved to the shard's device). Inside one process,
``psum`` / ``pmin`` / ``pmax`` are reductions over the shard list in
shard order and ``all_gather`` a stack; ``combine(fn, ...)`` runs any
cross-shard function once (the hand-written combine kernels of
``ops/mesh_combine.py`` go through it), its result either replicated or
one entry per shard. A body that yields nothing is a plain per-shard
function. On one card the shards' bodies share one stream, so they run
one after another: the mesh measures per-shard work and the combines,
no interconnect.

Axes. Every collective takes an optional ``axis``. None (or the one axis
of a 1-D mesh) combines every shard, as before. On a 2-D hybrid mesh
(``parallel/mesh.py``), ``SERIES_AXIS`` combines each host row's shards
in chip order and hands each shard its row's result, and ``HOST_AXIS``
combines each chip column (the same chip of every row) in row order and
hands each shard its column's result, as JAX's ``psum(x, HOST_AXIS)``
does. The hybrid bodies yield there only the host-level partials a
series collective has already handed every chip of the row: a row whose
chips yielded the very same tensors counts as one payload, so one
payload a row crosses a process boundary and, when every row is such,
the combine runs once for all the columns.

Across processes (a mesh with a ``plane``, ``parallel/fleet.py``): each
process steps its own shards. A collective that combines shards of
several processes first all-gathers the local payloads over the plane's
``torch.distributed`` group (``fleet.all_gather``: each payload's
tensors staged through pinned host memory under gloo), then runs the
same combine over the same payloads in the same order in every process,
so a mesh across processes gives the bits of the same mesh in one
process. A series collective on a hybrid mesh never crosses (a process
holds whole rows); a whole-mesh collective gathers every shard's
payload. Every process must reach the same collectives in the same
order, as under JAX's multi-controller model.

Client-controlled rate parameters (``counter_max``, ``reset_value``)
are operands, never statics, so distinct values never grow the cache
(the JAX package's recompile-DoS guard, kept as the same contract).

Observability: ``mesh.compile`` times dispatcher builds; ``mesh.dispatch``
times every mesh-leg dispatch; ``mesh.cache.hit`` / ``mesh.cache.miss``
count plan-cache outcomes; ``mesh.cache.size`` and ``mesh.devices`` gauge
the cache and the configured mesh width. Single-device calls are not
timed.
"""

from __future__ import annotations

import functools
import threading
import time as _time

import numpy as np
import torch

from opentsdb_tpu_torch.obs.registry import METRICS as _metrics
from opentsdb_tpu_torch.parallel.plan import ExecPlan

_M_COMPILE = _metrics.timer("mesh.compile")
_M_DISPATCH = _metrics.timer("mesh.dispatch")
_C_HIT = _metrics.counter("mesh.cache.hit")
_C_MISS = _metrics.counter("mesh.cache.miss")

# Process-wide mesh width for the /stats + /metrics gauge: 1 until a
# daemon configures a mesh (set_mesh_devices).
_MESH_DEVICES = 1
_metrics.gauge("mesh.devices", lambda: _MESH_DEVICES)
_metrics.gauge("mesh.cache.size", lambda: len(_CACHE))


def set_mesh_devices(n: int) -> None:
    global _MESH_DEVICES
    _MESH_DEVICES = int(n)


_CACHE: dict = {}
_CACHE_LOCK = threading.Lock()


def cache_info() -> dict:
    """Plan-cache counters for /api/queries (the compile-cache line)."""
    return {"size": len(_CACHE),
            "hit": int(_C_HIT.value),
            "miss": int(_C_MISS.value),
            "devices": _MESH_DEVICES}


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

class Collective:
    """One cross-shard step a mesh body yields: ``fn(payloads, device)``
    runs once on the mesh's first device over the payloads of the shards
    ``axis`` groups (in shard order). ``per_shard``: fn returns one
    result per shard of the group (shard i of the group gets entry i)
    instead of one replicated result."""

    __slots__ = ("fn", "payload", "per_shard", "axis")

    def __init__(self, fn, payload, per_shard: bool = False,
                 axis=None) -> None:
        self.fn = fn
        self.payload = payload
        self.per_shard = per_shard
        self.axis = axis


def _to(x, dev):
    """x (a tensor, or a tuple/list of tensors and Nones) on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, dev) for v in x)
    return x


def _shard_sum(xs, dev):
    acc = xs[0].to(dev)
    for x in xs[1:]:
        acc = acc + x.to(dev)
    return acc


def _shard_min(xs, dev):
    # NaN propagates, as XLA's min does; otherwise the strict order of
    # the shard list decides ties.
    acc = xs[0].to(dev)
    for x in xs[1:]:
        x = x.to(dev)
        acc = torch.where((x < acc) | torch.isnan(x), x, acc)
    return acc


def _shard_max(xs, dev):
    acc = xs[0].to(dev)
    for x in xs[1:]:
        x = x.to(dev)
        acc = torch.where((x > acc) | torch.isnan(x), x, acc)
    return acc


def _shard_stack(xs, dev):
    return torch.stack([x.to(dev) for x in xs])


def psum(x, axis=None) -> Collective:
    """Sum over the shards ``axis`` groups, in shard order."""
    return Collective(_shard_sum, x, axis=axis)


def pmin(x, axis=None) -> Collective:
    return Collective(_shard_min, x, axis=axis)


def pmax(x, axis=None) -> Collective:
    return Collective(_shard_max, x, axis=axis)


def all_gather(x, axis=None) -> Collective:
    """The grouped shards' x stacked along a new leading axis."""
    return Collective(_shard_stack, x, axis=axis)


def combine(fn, *payload, per_shard: bool = False,
            axis=None) -> Collective:
    """A cross-shard function run once per group: ``fn(payloads,
    device)`` with ``payloads[i]`` the tuple shard i of the group
    yielded."""
    return Collective(fn, payload, per_shard, axis)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _place(x, dev):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return x


def _collective_groups(mesh, axis):
    """How a collective over ``axis`` groups the shards: ("all", None)
    every shard; ("rows", C) each host row of C shards (local to a
    process); ("hosts", C) each chip column, the same chip of every host
    row, as JAX's collectives over the host axis group them."""
    names = mesh.axis_names
    if axis is None or axis == names or len(names) == 1:
        if axis is not None and len(names) == 1 and axis != names[0]:
            raise ValueError(f"collective over {axis!r} on a mesh with "
                             f"axis {names[0]!r}")
        return "all", None
    if axis not in names:
        raise ValueError(f"collective over {axis!r} on a mesh with axes "
                         f"{names}")
    C = mesh.shape[1]
    return ("hosts", C) if axis == names[0] else ("rows", C)


def _gather(mesh, plan: ExecPlan, payloads: list, first) -> list:
    """The payloads of every process of the mesh's plane, in process
    order (this process's own without a plane)."""
    if mesh.plane is None:
        return payloads
    from opentsdb_tpu_torch.parallel import fleet

    return fleet.all_gather(payloads, mesh.devices[0],
                            tag=(plan.name, first.fn.__qualname__,
                                 first.axis))


def _same_payload(a, b) -> bool:
    """b holds the very tensors of a, and equal plain values."""
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same_payload(x, y) for x, y in zip(a, b))
    if a is b:
        return True
    plain = (str, int, float, bool, type(None))
    return type(a) is type(b) and isinstance(a, plain) and a == b


def _host_collective(mesh, plan: ExecPlan, steps, send, C: int) -> None:
    """A host-axis collective: each chip column combined over the host
    rows, in row order. A row whose chips yielded the very same tensors
    (what a series collective hands the chips of a row on one device) is
    one payload, sent across processes and combined once; when every
    row is, the columns are one group and the combine runs once."""
    first = steps[0]
    target = mesh.devices[0]
    rows = [[s.payload for s in steps[lo:lo + C]]
            for lo in range(0, len(steps), C)]
    packed = [(True, r[0]) if all(_same_payload(r[0], p) for p in r[1:])
              else (False, r) for r in rows]
    packed = _gather(mesh, plan, packed, first)
    if all(one for one, _ in packed):
        res = [first.fn([p for _, p in packed], target)] * C
    else:
        # Every row's payloads, row-major: column c is full[c::C].
        full = [p for one, r in packed for p in ([r] * C if one else r)]
        res = [first.fn(full[c::C], target) for c in range(C)]
    for d, dev in enumerate(mesh.devices):
        send[d] = _to(res[d % C], dev)


def _step_collective(mesh, plan: ExecPlan, steps, send) -> None:
    """Run the collective every local shard reached; fill ``send``."""
    first = steps[0]
    kind, C = _collective_groups(mesh, first.axis)
    target = mesh.devices[0]
    D = len(steps)
    if kind == "rows":
        for lo in range(0, D, C):
            res = first.fn([s.payload for s in steps[lo:lo + C]], target)
            for i in range(C):
                send[lo + i] = _to(res[i] if first.per_shard else res,
                                   mesh.devices[lo + i])
        return
    if kind == "hosts":
        if first.per_shard:
            raise ValueError(f"plan {plan.name}: a host-axis collective "
                             f"is replicated, never per shard")
        _host_collective(mesh, plan, steps, send, C)
        return
    payloads = _gather(mesh, plan, [s.payload for s in steps], first)
    res = first.fn(payloads, target)
    for d, dev in enumerate(mesh.devices):
        send[d] = _to(res[mesh.offset + d] if first.per_shard else res,
                      dev)


def _run_shards(body, mesh, plan: ExecPlan, args) -> list:
    """Each local shard's body on its device, collectives in lockstep;
    the per-shard return values."""
    D = len(mesh.devices)
    specs = plan.in_specs
    if len(specs) != len(args):
        raise ValueError(f"plan {plan.name}: {len(args)} inputs, "
                         f"{len(specs)} specs")
    for a, spec in zip(args, specs):
        if spec is not None and a.shape[0] != D:
            raise ValueError(f"plan {plan.name}: a sharded input has "
                             f"{a.shape[0]} rows, the mesh {D} shards")
    gens, outs, steps = [], [None] * D, [None] * D
    base = mesh.offset
    for d, dev in enumerate(mesh.devices):
        shard_args = [_place(a[d] if spec is not None else a, dev)
                      for a, spec in zip(args, specs)]
        res = body(*shard_args, axis_index=base + d)
        gens.append(res if hasattr(res, "send") else None)
        if gens[d] is None:
            outs[d] = res
    live = [d for d in range(D) if gens[d] is not None]
    if not live:
        return outs
    if len(live) != D:
        raise RuntimeError(f"plan {plan.name}: shards disagree on "
                           f"whether the body has collectives")
    send = [None] * D
    while True:
        done = 0
        for d in range(D):
            try:
                steps[d] = gens[d].send(send[d])
            except StopIteration as stop:
                outs[d] = stop.value
                steps[d] = None
                done += 1
        if done == D:
            return outs
        if done or any(s.fn is not steps[0].fn or s.axis != steps[0].axis
                       for s in steps):
            raise RuntimeError(f"plan {plan.name}: shards reached "
                               f"different collectives")
        _step_collective(mesh, plan, steps, send)


def _gather_out(outs, spec, dev):
    if spec is None:
        return outs[0]
    return torch.cat([o.to(dev) for o in outs])


class _MeshDispatch:
    """Mesh-leg callable: runs the plan over the mesh and times every
    dispatch under ``mesh.dispatch``."""

    __slots__ = ("_body", "_plan", "_mesh")

    def __init__(self, body, plan: ExecPlan, mesh) -> None:
        self._body = body
        self._plan = plan
        self._mesh = mesh

    def __call__(self, *args):
        t0 = _time.perf_counter()
        plan, mesh = self._plan, self._mesh
        if plan.in_specs is None:
            out = self._body(*args)
        else:
            outs = _run_shards(self._body, mesh, plan, args)
            dev = mesh.devices[0]
            if isinstance(plan.out_specs, tuple):
                out = tuple(_gather_out([o[i] for o in outs], spec, dev)
                            for i, spec in enumerate(plan.out_specs))
            else:
                out = _gather_out(outs, plan.out_specs, dev)
        _M_DISPATCH.observe((_time.perf_counter() - t0) * 1000.0)
        return out


def compile_with_plan(fn, plan: ExecPlan, mesh=None, statics: tuple = ()):
    """The dispatcher of ``fn`` per ``plan`` over ``mesh``; cached.

    ``statics``: hashable ((name, value), ...) keyword bindings; they
    bind into the body (and into the cache key)."""
    key = (fn, plan, mesh, statics)
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
    if hit is not None:
        _C_HIT.inc()
        return hit
    _C_MISS.inc()
    with _M_COMPILE.time():
        body = functools.partial(fn, **dict(statics)) if statics else fn
        wrapped = body if mesh is None else _MeshDispatch(body, plan, mesh)
    with _CACHE_LOCK:
        # First writer wins, so concurrent builders share one dispatcher.
        return _CACHE.setdefault(key, wrapped)


def jit_plan(plan: ExecPlan):
    """Decorator form for module-level single-device functions: records
    the plan and routes the function through the plane's cache."""
    def deco(fn):
        return compile_with_plan(fn, plan, None)
    return deco


def clear_cache() -> None:
    """Test hook: drop every cached dispatcher."""
    with _CACHE_LOCK:
        _CACHE.clear()
