"""The port's configuration object and device resolution.

Mirrors ``opentsdb_tpu/utils/config.py`` of the JAX package, trimmed to
the fields this port reads, plus ``device``: where the query kernels run.
``backend="cpu"`` keeps its JAX-package meaning — the float64 numpy
oracle answers every query (``ops/oracle.py``) — and is independent of
``device``.
"""

from __future__ import annotations

import dataclasses
import multiprocessing

import torch


@dataclasses.dataclass
class Config:
    # storage
    table: str = "tsdb"
    uidtable: str = "tsdb-uid"

    # core behavior (names mirror the reference's system properties)
    auto_create_metrics: bool = False   # tsd.core.auto_create_metrics
    enable_compactions: bool = True     # tsd.feature.compactions
    flush_interval: float = 10.0        # compaction thread wake period (s)
    compaction_min_flush_threshold: int = 100
    compaction_max_concurrent_flushes: int = 10_000
    compaction_flush_speed: int = 2

    # compute: 'device' = the port's kernels on ``device``; 'cpu' = the
    # float64 numpy oracle.
    backend: str = "device"
    # Torch device of the query kernels. "cuda" by default: the port is
    # built for one NVIDIA H100, and a missing card is an error, never a
    # silent CPU run. Tests pass "cpu".
    device: str = "cuda"

    # network
    port: int = 4242
    bind: str = "0.0.0.0"
    worker_threads: int = dataclasses.field(
        default_factory=lambda: 2 * multiprocessing.cpu_count())


def resolve_device(name: str) -> torch.device:
    """``name`` as a torch device, refusing a CUDA device without a card:
    the port runs where its caller asked or not at all."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; pass "
            f"device='cpu' to run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev
