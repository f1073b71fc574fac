"""Mesh parallelism in one process: meshes, the execution plane and the
sharded query bodies.

Mirrors ``opentsdb_tpu/parallel/``. Series are sharded over the devices
of a :class:`~opentsdb_tpu_torch.parallel.mesh.Mesh`; each shard's body
reduces its own series, and the partial aggregates combine across the
shards on the mesh's first device (``parallel/compile.py``): moments by
the exact pairwise (Chan et al.) merge, in one hand-written kernel
(``ops/mesh_combine.py``), sketches by register max or recompression.
Time-axis sharding (``parallel/timeshard.py``) exchanges per-series edge
carries between tiles for rate and fill correctness, selected by the
second hand-written kernel. A mesh is a list of torch devices in which
a device may repeat, so the whole path runs as logical shards on one
CPU or one card.

A mesh may also fold its shards into the hybrid (host, series) grid
(``parallel/multihost.py``: two-level moment, HLL and t-digest merges,
the moments in the third hand-written kernel), span the processes of a
mesh plane (``parallel/fleet.py``: a ``torch.distributed`` group whose
collectives carry only host-level partials), or split by aggregator
family (``parallel/expert.py``: a mixed dashboard in one dispatch,
finished by the ``dash_finish`` kernel of ``ops/expert_finish.py``).
"""

from opentsdb_tpu_torch.parallel.mesh import (
    EXPERT_AXIS,
    HOST_AXIS,
    SERIES_AXIS,
    TIME_AXIS,
    Mesh,
    make_mesh,
)
from opentsdb_tpu_torch.parallel.plan import (
    ExecPlan,
    build_mesh,
    flatten_series_mesh,
)

__all__ = ["make_mesh", "Mesh", "SERIES_AXIS", "TIME_AXIS", "EXPERT_AXIS",
           "HOST_AXIS", "ExecPlan", "build_mesh", "flatten_series_mesh"]
