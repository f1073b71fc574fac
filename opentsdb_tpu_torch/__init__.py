"""opentsdb_tpu_torch — the PyTorch / CUDA port of opentsdb_tpu.

The same system as the JAX package beside it (``opentsdb_tpu``): telnet and
HTTP ``put`` ingest, UID-packed row storage behind a WAL, and downsampled,
rate and group-by ``/q`` queries. Plain tensor code is PyTorch; every
kernel the JAX package wrote in Pallas is a kernel written by hand for an
NVIDIA Hopper card (``csrc/``, built with ``nvcc`` at first use).

The port imports ``torch`` and numpy and nothing of the JAX package: where
it needs one of that package's JAX-free modules it keeps its own copy,
whose docstring names the module it mirrors. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; without a card the default
raises instead of carrying on on the CPU.

Layering mirrors the JAX package:
    core     codecs & schema, TSDB facade, compaction
    storage  in-memory ordered KV + WAL (byte-compatible with the JAX WAL)
    uid      name<->id dictionaries
    ops      segment-reduce kernels (CUDA) and the downsample core
    query    planner/executor + Aggregators registry
    server   asyncio telnet + HTTP front end
    tools    the ``tsd`` command
"""

__version__ = "0.1.0"
