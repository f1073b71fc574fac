"""Device meshes: an ordered list of torch devices on one or two named
axes.

Mirrors ``opentsdb_tpu/parallel/mesh.py``. A JAX mesh is a grid of
distinct devices; here a ``Mesh`` is an ordered list of torch devices in
which one device may appear more than once. That is the counterpart of
the JAX package's virtual CPU devices: ``Mesh(["cpu"] * 8)`` runs eight
logical shards in one process on the CPU, and ``Mesh(["cuda:0"] * 4)``
four logical shards on one card. Shard i's body runs on
``mesh.devices[i]``; the cross-shard combines of the execution plane
(``parallel/compile.py``) run on ``mesh.devices[0]``.

A mesh has one axis or two. The 2-D form is the hybrid mesh of
``opentsdb_tpu/parallel/multihost.py``: ``(R, C)`` shards on
``(HOST_AXIS, SERIES_AXIS)``, host-major, so shard ``r * C + c`` is chip
``c`` of host row ``r``. ``Mesh(["cuda:0"] * 4, (HOST_AXIS,
SERIES_AXIS), shape=(2, 2))`` is four logical shards of one card folded
2 x 2. A mesh may span the processes of a mesh plane
(``parallel/fleet.py``): ``plane=(process_index, process_count)``. Each
process then holds its own block of the shards (``devices`` are this
process's, ``shape`` its local fold) and ``size`` counts the shards of
every process; on a hybrid mesh each process holds whole host rows, so
only collectives over the host axis cross a process boundary.
"""

from __future__ import annotations

SERIES_AXIS = "series"  # data-parallel axis: series blocks across shards
TIME_AXIS = "time"      # sequence-parallel axis: contiguous time tiles
EXPERT_AXIS = "expert"  # expert axis: aggregator families across shards
HOST_AXIS = "host"      # multi-host axis: collectives here cross hosts


class _Devices(tuple):
    """The mesh's devices (this process's, flat, host-major); ``size`` as
    on a JAX mesh's device array, ``shape`` the local fold."""

    @property
    def size(self) -> int:
        return len(self)


class Mesh:
    """An ordered device list on one axis, or folded on two. Hashable (a
    plan-cache key component); two meshes are equal when their devices,
    axes, fold and plane are."""

    __slots__ = ("devices", "axis_names", "shape", "plane")

    def __init__(self, devices, axis_names=(SERIES_AXIS,), shape=None,
                 plane=None) -> None:
        import torch

        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        axis_names = tuple(axis_names)
        devs = _Devices(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(axis_names) == 1:
            shape = (len(devs),) if shape is None else tuple(shape)
            if shape != (len(devs),):
                raise ValueError(f"a 1-D mesh of {len(devs)} devices "
                                 f"cannot have shape {shape}")
        elif len(axis_names) == 2:
            if shape is None or len(shape) != 2 \
                    or shape[0] * shape[1] != len(devs):
                raise ValueError(f"{len(devs)} devices don't fold into "
                                 f"shape {shape}")
            shape = (int(shape[0]), int(shape[1]))
        else:
            raise ValueError(f"a port mesh has one or two axes, got "
                             f"{axis_names}")
        if plane is not None:
            pid, count = int(plane[0]), int(plane[1])
            if count < 1 or not 0 <= pid < count:
                raise ValueError(f"mesh plane process {pid}/{count} out "
                                 f"of range")
            plane = None if count == 1 else (pid, count)
        devs.shape = shape
        self.devices = devs
        self.axis_names = axis_names
        self.shape = shape
        self.plane = plane

    @property
    def processes(self) -> int:
        return 1 if self.plane is None else self.plane[1]

    @property
    def size(self) -> int:
        """Shards over every process of the mesh."""
        return len(self.devices) * self.processes

    @property
    def offset(self) -> int:
        """The global index of this process's first shard."""
        return 0 if self.plane is None else self.plane[0] * len(self.devices)

    @property
    def global_shape(self) -> tuple:
        """The fold over every process: host rows (or the one axis)
        multiply by the process count."""
        return (self.shape[0] * self.processes,) + self.shape[1:]

    def _key(self) -> tuple:
        return (tuple(str(d) for d in self.devices), self.axis_names,
                self.shape, self.plane)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        extra = "" if len(self.axis_names) == 1 else f", {self.shape}"
        if self.plane is not None:
            extra += f", plane={self.plane}"
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.axis_names}{extra})")


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
              devices=None, plane=None) -> Mesh:
    """A 1-D mesh over the first n devices (default: all cards).

    Series sharding is the primary axis: every shard owns a block of
    series and all of their points, so downsample and per-series math
    need no communication; only the cross-series group stage combines
    over the mesh. Pass ``devices`` to mesh logical shards, e.g.
    ``["cpu"] * 8`` for the CPU test mesh, and ``plane`` (process index,
    process count) for a series mesh that spans a mesh plane's
    processes, each holding its own n devices."""
    if devices is None:
        devices = local_devices()
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices, (axis,), plane=plane)
