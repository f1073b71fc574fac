"""Served mesh-plane membership: ``tsd --mesh-plane`` bootstrap, and the
transport of the mesh collectives that cross processes.

Mirrors ``opentsdb_tpu/parallel/fleet.py``. Every ``tsd`` process
launched with ``--mesh-plane HOST:PORT`` joins one ``torch.distributed``
group (``init_process_group`` over ``tcp://HOST:PORT``, a world size
and a rank given by the flags) before the storage engine builds a
window, so the fleet knows its members and each process its share of
the mesh devices.

Serving stays multi-controller, as in the JAX package: per-request
collectives across processes would make every query wait for every
peer, so query traffic never crosses. Each process shards its resident
hot set over its own mesh devices (``storage/devshard.py``) and the
router weights ownership by each backend's advertised width. The plane
buys the fleet boot-time membership checks (a misconfigured process
fails at the join, never serves as a silent singleton) and the
transport for the legs that do run one program across processes: the
hybrid mesh's host-axis merges (``parallel/multihost.py``) and series
meshes that span the plane (``parallel/compile.py``).

The transport. A collective that crosses processes all-gathers each
process's payloads (``all_gather``): [B]-sized moment rows, HLL
registers, compressed digests, never points. Two backends:

- gloo (TCP, host memory): a CUDA tensor takes part in gloo only
  through broadcast / all_reduce, so each payload's tensors are staged
  through pinned host memory and the gathered rows copied back to the
  combine device. It runs anywhere, two ranks on one card included.
- NCCL: only when every rank holds a card of its own (NCCL refuses two
  ranks on one card). The plane joins over gloo, every rank reports its
  host and card, and an NCCL group is made exactly when they are all
  distinct; the tensors then gather card to card.

``init_plane`` is idempotent per process and raises on a malformed spec
or a failed join.
"""

from __future__ import annotations

import datetime
import logging
import pickle
import socket

LOG = logging.getLogger("opentsdb.fleet")

# The one plane this process joined (None until init_plane succeeds),
# its collectives' group and the group tensors gather over (NCCL or
# the gloo group itself).
_PLANE: dict | None = None
_GROUP = None
_DATA_GROUP = None

# Seconds a join, and every collective after it, may wait for a peer.
DEFAULT_TIMEOUT_S = 60.0


def _card_identity(device: str):
    """(host, card uuid) of this rank's card, or None off CUDA."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(idx)
    return (socket.gethostname(), str(getattr(props, "uuid", idx)))


def init_plane(coordinator: str, num_processes: int, process_id: int, *,
               devices_local: int = 1, device: str = "cpu",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """Join the serving mesh plane. Returns the plane-info dict (also
    cached for ``plane_info()``): process id and count, and the
    local / global split of the mesh devices. ``devices_local`` is the
    number of mesh devices this process runs (logical shards count, as
    the JAX package's virtual CPU devices do); ``devices_global`` is
    their sum over the plane, from an all-gather at the join that also
    proves the transport at boot. ``device`` is this process's torch
    device: the NCCL rule reads it.

    Raises on a malformed spec or a failed join: a daemon that was asked
    to be part of a mesh must not boot as a silent singleton."""
    global _PLANE, _GROUP, _DATA_GROUP
    if _PLANE is not None:
        return _PLANE
    if not coordinator or ":" not in coordinator:
        raise ValueError(
            f"--mesh-plane needs HOST:PORT, got {coordinator!r}")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(
            f"mesh plane process {process_id}/{num_processes} out of "
            f"range")
    if devices_local < 1:
        raise ValueError(f"mesh plane process {process_id}: "
                         f"{devices_local} local devices")
    backend = "gloo"
    devices_global = devices_local
    if num_processes > 1:
        import torch.distributed as dist

        timeout = datetime.timedelta(seconds=timeout_s)
        try:
            dist.init_process_group(
                backend="gloo", init_method=f"tcp://{coordinator}",
                world_size=num_processes, rank=process_id,
                timeout=timeout)
        except Exception as e:
            raise RuntimeError(
                f"mesh plane {coordinator}: process {process_id}/"
                f"{num_processes} failed to join: {e}") from e
        _GROUP = dist.group.WORLD
        members: list = [None] * num_processes
        dist.all_gather_object(members, (devices_local,
                                         _card_identity(device)))
        devices_global = sum(m[0] for m in members)
        cards = [m[1] for m in members]
        # NCCL only when every rank holds a card of its own.
        if all(c is not None for c in cards) \
                and len(set(cards)) == num_processes:
            _DATA_GROUP = dist.new_group(backend="nccl", timeout=timeout)
            backend = "nccl"
        else:
            _DATA_GROUP = _GROUP
    _PLANE = {
        "coordinator": coordinator,
        "process_id": int(process_id),
        "process_count": int(num_processes),
        "devices_local": int(devices_local),
        "devices_global": int(devices_global),
        "backend": backend,
    }
    LOG.info("joined mesh plane %s as process %d/%d (%d local / %d "
             "global devices, %s)", coordinator, process_id,
             num_processes, devices_local, devices_global, backend)
    return _PLANE


def plane_info() -> dict | None:
    """The plane this process joined, or None outside mesh-plane
    mode. Read by /healthz and the /api/queries mesh section."""
    return _PLANE


def plane() -> tuple | None:
    """(process index, process count) of the joined plane, the form a
    ``Mesh`` takes, or None."""
    if _PLANE is None or _PLANE["process_count"] == 1:
        return None
    return (_PLANE["process_id"], _PLANE["process_count"])


# ---------------------------------------------------------------------------
# The cross-process gather
# ---------------------------------------------------------------------------

def _strip(obj, tensors: list):
    """obj with each tensor replaced by its index in ``tensors``."""
    import torch

    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return _Slot(len(tensors) - 1)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_strip(v, tensors) for v in obj)
    return obj


def _fill(obj, tensors: list):
    if isinstance(obj, _Slot):
        return tensors[obj.i]
    if isinstance(obj, (tuple, list)):
        return type(obj)(_fill(v, tensors) for v in obj)
    return obj


class _Slot:
    """Where a payload's tensor stood (its index in the tensor list)."""
    __slots__ = ("i",)

    def __init__(self, i: int) -> None:
        self.i = i


def _staged(tensors: list) -> list:
    """Host copies of ``tensors``: CUDA ones through pinned buffers,
    synchronised once."""
    import torch

    out, cards = [], set()
    for t in tensors:
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            cards.add(t.device)
            out.append(buf)
        else:
            out.append(t.contiguous())
    for dev in cards:
        torch.cuda.synchronize(dev)
    return out


def all_gather(payloads: list, device, *, tag=None) -> list:
    """Every process's ``payloads`` (a list of tuples of tensors and
    plain values), concatenated in process order, their tensors on
    ``device``. ``tag`` names the collective: processes that reached
    different collectives raise instead of combining mismatched data."""
    import torch
    import torch.distributed as dist

    if _GROUP is None:
        raise RuntimeError("a mesh spans processes but this process has "
                           "joined no mesh plane (fleet.init_plane)")
    n = _PLANE["process_count"]
    tensors: list = []
    shape = _strip(list(payloads), tensors)
    if _PLANE["backend"] == "nccl":
        meta = (tag, shape, [(tuple(t.shape), t.dtype) for t in tensors])
        metas: list = [None] * n
        dist.all_gather_object(metas, meta, group=_GROUP)
        _check_tags(metas, tag)
        # NCCL gathers equal shapes only; processes whose payloads differ
        # in their tensors gather on the host below.
        if all(m[2] == meta[2] for m in metas):
            rows: list = [[None] * len(tensors) for _ in range(n)]
            for i, t in enumerate(tensors):
                t = t.to(device).contiguous()
                parts = [torch.empty_like(t) for _ in range(n)]
                dist.all_gather(parts, t, group=_DATA_GROUP)
                for p in range(n):
                    rows[p][i] = parts[p]
            out = []
            for p in range(n):
                out.extend(_fill(metas[p][1], rows[p]))
            return out
    blob = pickle.dumps((tag, shape, _staged(tensors)))
    gathered: list = [None] * n
    dist.all_gather_object(gathered, blob, group=_GROUP)
    parts = [pickle.loads(b) for b in gathered]
    _check_tags(parts, tag)
    out = []
    for _, pshape, ptensors in parts:
        out.extend(_fill(pshape, [t.to(device) for t in ptensors]))
    return out


def _check_tags(parts, tag) -> None:
    tags = [p[0] for p in parts]
    if any(t != tag for t in tags):
        raise RuntimeError(f"mesh plane processes reached different "
                           f"collectives: {tags}")


def _reset_for_tests() -> None:
    """Leave the plane (destroying the process group) and forget it."""
    global _PLANE, _GROUP, _DATA_GROUP
    if _GROUP is not None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    _PLANE = None
    _GROUP = None
    _DATA_GROUP = None
