"""The port's configuration object and device resolution.

Mirrors ``opentsdb_tpu/utils/config.py`` of the JAX package, trimmed to
the fields this port reads (the resident window's, the spill tier's, the
live sketches' and the fragment cache's among them, with the JAX
package's defaults), plus
``device``: where the query kernels run.
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
    throttle_rows: int | None = None  # memtable rows before PleaseThrottle

    # core behavior (names mirror the reference's system properties)
    auto_create_metrics: bool = False   # tsd.core.auto_create_metrics
    enable_compactions: bool = True     # tsd.feature.compactions
    flush_interval: float = 10.0        # compaction thread wake period (s)
    compaction_min_flush_threshold: int = 100
    compaction_max_concurrent_flushes: int = 10_000
    compaction_flush_speed: int = 2
    checkpoint_interval: float = 0.0    # spill+WAL-truncate period (s); 0=off

    # compute: 'device' = the port's kernels on ``device``; 'cpu' = the
    # float64 numpy oracle.
    backend: str = "device"
    # Torch device of the query kernels. "cuda" by default: the port is
    # built for one NVIDIA H100, and a missing card is an error, never a
    # silent CPU run. Tests pass "cpu".
    device: str = "cuda"

    # Query fast path (query/executor.py, the fragment cache): decoded
    # per-(selector, aligned time-chunk) columns, validated against the
    # store's mutation seq, per-base transition stamps and dirty-base set
    # (MemKVStore.chunk_state). Chunks with memtable rows are re-read on
    # every query; clean history serves from RAM, bit-identical to a cold
    # scan. The JAX package's names and defaults.
    qcache: bool = True
    qcache_chunk_s: int = 6 * 3600   # chunk width (rounded to row span)
    qcache_points: int = 1 << 24     # total cached points across fragments
    qcache_fragments: int = 1024     # max distinct fragments
    qcache_max_chunks: int = 512     # wider ranges scan unchunked/uncached

    # Streaming sketches (stats/livesketch.py): a t-digest per series and
    # a HyperLogLog per (metric, tag key), folded on the device at ingest.
    # The JAX package's names and defaults.
    enable_sketches: bool = True
    sketch_compression: int = 128       # t-digest centroids per series
    sketch_hll_p: int = 12              # 2^p registers per (metric, tagk)
    sketch_flush_points: int = 1 << 20  # buffered points before a fold

    # Device-resident columnar hot window (storage/devstore.py): ingest is
    # mirrored into device memory so downsampled moment queries skip the
    # storage scan and the per-query host-to-device copy. The JAX
    # package's names and defaults.
    device_window: bool = True
    device_window_staging: int = 1 << 20   # points per upload chunk
    device_window_points: int = 1 << 26    # resident budget, all metrics

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
