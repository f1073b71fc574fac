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

    ``"N"`` builds a 1-D series mesh of N shards. On the CPU (``device``
    of type cpu) they are N logical shards on the one CPU device, the
    counterpart of the JAX package's virtual CPU devices. On CUDA, N
    must not exceed the cards of this process: asking for more is a
    loud boot error, never a quiet single-device fallback. ``devices``
    overrides the list the shards take the first N of.

    ``"RxC"`` (the JAX package's hybrid host x series mesh) is not
    ported yet (ROADMAP item 11b) and raises."""
    shape = shape.strip().lower()
    if not shape:
        raise ValueError("empty mesh shape")
    if "x" in shape:
        raise ValueError(f"mesh shape {shape!r}: the hybrid RxC mesh is "
                         f"not yet ported (item 11b)")
    n = int(shape)
    if n <= 0:
        raise ValueError(f"bad mesh shape {shape!r}")
    if devices is None:
        devs = local_devices(device)
        if devs and devs[0].type == "cpu":
            devs = devs * n
    else:
        devs = list(devices)
    if n > len(devs):
        raise ValueError(f"mesh {shape} needs {n} devices, have "
                         f"{len(devs)}")
    return make_mesh(n, devices=devs)


def flatten_series_mesh(mesh):
    """1-D series-axis view of any mesh (the series-sharded kernels run
    over every device whatever the mesh's axis)."""
    if getattr(mesh, "axis_names", None) in (None, (SERIES_AXIS,)):
        return mesh
    return Mesh(mesh.devices, (SERIES_AXIS,))


__all__ = ["ExecPlan", "build_mesh", "flatten_series_mesh", "BATCH_AXES",
           "STYLES", "HOST_AXIS", "SERIES_AXIS"]
