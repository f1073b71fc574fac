"""Device meshes: an ordered list of torch devices on one named axis.

Mirrors ``opentsdb_tpu/parallel/mesh.py``. A JAX mesh is a grid of
distinct devices; here a ``Mesh`` is an ordered list of torch devices in
which one device may appear more than once. That is the counterpart of
the JAX package's virtual CPU devices: ``Mesh(["cpu"] * 8)`` runs eight
logical shards in one process on the CPU, and ``Mesh(["cuda:0"] * 4)``
four logical shards on one card. Shard i's body runs on
``mesh.devices[i]``; the cross-shard combines of the execution plane
(``parallel/compile.py``) run on ``mesh.devices[0]``.
"""

from __future__ import annotations

SERIES_AXIS = "series"  # data-parallel axis: series blocks across shards
TIME_AXIS = "time"      # sequence-parallel axis: contiguous time tiles
EXPERT_AXIS = "expert"  # expert axis: aggregator families across shards
HOST_AXIS = "host"      # multi-host axis: collectives here cross hosts


class _Devices(tuple):
    """The mesh's devices; ``size`` as on a JAX mesh's device array."""

    @property
    def size(self) -> int:
        return len(self)


class Mesh:
    """An ordered device list on one axis. Hashable (a plan-cache key
    component); two meshes are equal when their devices and axis are."""

    __slots__ = ("devices", "axis_names")

    def __init__(self, devices, axis_names=(SERIES_AXIS,)) -> None:
        import torch

        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        if len(axis_names) != 1:
            raise ValueError(f"a port mesh has one axis, got {axis_names}")
        devs = _Devices(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = devs
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    def _key(self) -> tuple:
        return (tuple(str(d) for d in self.devices), self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.axis_names})")


def local_devices(device="cuda") -> list:
    """Every device of ``device``'s kind in this process: each card for
    CUDA, the one CPU device for the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(n_devices: int | None = None, axis: str = SERIES_AXIS,
              devices=None) -> Mesh:
    """A 1-D mesh over the first n devices (default: all cards).

    Series sharding is the primary axis: every shard owns a block of
    series and all of their points, so downsample and per-series math
    need no communication; only the cross-series group stage combines
    over the mesh. Pass ``devices`` to mesh logical shards, e.g.
    ``["cpu"] * 8`` for the CPU test mesh."""
    if devices is None:
        devices = local_devices()
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices, (axis,))
