"""Declarative execution plans for the mesh execution plane.

Mirrors ``opentsdb_tpu/parallel/plan.py``. An :class:`ExecPlan` names a
kernel body, the axis its batch dimension shards over (``series`` for
series-hash blocks, ``time`` for bucket-aligned tiles, ``block`` for the
compressed-block axis, ``expert``, ``host``) and, for mesh execution,
which inputs split over the mesh and how the outputs come back.
``parallel/compile.py`` ``compile_with_plan`` consumes it.

Specs, in the port: ``in_specs`` holds one entry per positional input,
an axis name (the input is stacked [D, ...] and shard i gets row i) or
None (replicated: every shard gets the whole input); ``out_specs`` is
one such entry, or a tuple of them for a tuple of outputs, an axis name
concatenating the shards' outputs along dimension 0 on the mesh's first
device (a body returns ``x[None]`` to stack, as under JAX's
``shard_map``) and None taking shard 0's output (a replicated answer).
``in_specs=None`` means the plan only ever runs single-device. The JAX
plan's ``static_argnames`` / ``donate_argnums`` have no counterpart:
statics bind through ``compile_with_plan``'s ``statics``, and eager
PyTorch donates nothing.

The style labels are the JAX package's. The port runs every mesh plan
one way (the per-shard body, then the cross-shard combines on the first
device), so ``style`` is validated and recorded but selects nothing.
"""

from __future__ import annotations

import dataclasses

from opentsdb_tpu_torch.parallel.mesh import (
    HOST_AXIS,
    SERIES_AXIS,
    Mesh,
    local_devices,
    make_mesh,
)

# Batch-axis labels a plan may declare. "block" is the TSST4 compressed
# block axis: it shards like series (a block, like a series, is an
# indivisible unit of points).
BATCH_AXES = ("series", "time", "expert", "host", "block", None)

# Compile styles of the JAX package's plane, kept as plan labels.
STYLES = ("jit", "pjit", "shard_map")


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """How one kernel body runs (and optionally shards) over a mesh.
    Hashable and frozen: a plan is a cache-key component."""
    name: str
    axis: str | None = None          # batch axis label (BATCH_AXES)
    style: str = "jit"               # JAX-side style label (STYLES)
    in_specs: tuple | None = None
    out_specs: object | None = None

    def __post_init__(self):
        if self.axis not in BATCH_AXES:
            raise ValueError(f"plan {self.name}: unknown axis "
                             f"{self.axis!r} (expected one of "
                             f"{BATCH_AXES})")
        if self.style not in STYLES:
            raise ValueError(f"plan {self.name}: unknown style "
                             f"{self.style!r} (expected one of "
                             f"{STYLES})")


# ---------------------------------------------------------------------------
# Mesh construction from the config knob
# ---------------------------------------------------------------------------

def build_mesh(shape: str, devices=None, *, device="cuda") -> Mesh:
    """Mesh from the ``Config.mesh_shape`` / ``tsd --mesh`` knob.

    ``"N"`` builds a 1-D series mesh of N shards; ``"RxC"`` the 2-D
    hybrid (host, series) mesh of R host rows of C chips
    (``parallel/multihost.py`` ``make_hybrid_mesh``). On the CPU
    (``device`` of type cpu) the shards are logical shards of the one
    CPU device, the counterpart of the JAX package's virtual CPU
    devices. On CUDA the shards take this process's cards, and asking
    for more shards than cards is a loud boot error with the JAX
    package's text, never a quiet single-device fallback (a fold of
    logical shards of one card is built with ``make_hybrid_mesh`` and a
    ``devices`` list that repeats it). ``devices`` overrides the list
    the shards take the first N (or R * C) of."""
    shape = shape.strip().lower()
    if not shape:
        raise ValueError("empty mesh shape")
    if devices is None:
        devs = local_devices(device)
        cpu = bool(devs) and devs[0].type == "cpu"
    else:
        devs, cpu = list(devices), False
    if "x" in shape:
        r_s, _, c_s = shape.partition("x")
        r, c = int(r_s), int(c_s)
        if r <= 0 or c <= 0:
            raise ValueError(f"bad mesh shape {shape!r}")
        from opentsdb_tpu_torch.parallel.multihost import make_hybrid_mesh
        if cpu:
            devs = devs * (r * c)
        if r * c > len(devs):
            raise ValueError(f"mesh {shape} needs {r * c} devices, have "
                             f"{len(devs)}")
        return make_hybrid_mesh(r, c, devices=devs[:r * c])
    n = int(shape)
    if n <= 0:
        raise ValueError(f"bad mesh shape {shape!r}")
    if cpu:
        devs = devs * n
    if n > len(devs):
        raise ValueError(f"mesh {shape} needs {n} devices, have "
                         f"{len(devs)}")
    return make_mesh(n, devices=devs)


def flatten_series_mesh(mesh):
    """1-D series-axis view of any mesh: the series-sharded query bodies
    and the window fold run over every shard whatever the (host, series)
    fold; the fold matters only to the hybrid bodies."""
    if getattr(mesh, "axis_names", None) in (None, (SERIES_AXIS,)):
        return mesh
    return Mesh(mesh.devices, (SERIES_AXIS,), plane=mesh.plane)


__all__ = ["ExecPlan", "build_mesh", "flatten_series_mesh", "BATCH_AXES",
           "STYLES", "HOST_AXIS", "SERIES_AXIS"]
