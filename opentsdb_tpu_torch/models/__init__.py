"""Time-series model families: smoothing, forecasting, anomaly bands.

Mirrors ``opentsdb_tpu/models/`` of the JAX package: batched EWMA, Holt's
linear trend and additive Holt-Winters over a query's result series, all
series advanced in lockstep. The JAX package's ``lax.scan``s are the
hand-written scan kernels of ``csrc/smoothing.cu`` here
(``ops/smoothing.py``).
"""

from opentsdb_tpu_torch.models.smoothing import (  # noqa: F401
    anomaly_bands,
    anomaly_bands_plain,
    ewma,
    ewma_plain,
    holt_winters,
    holt_winters_plain,
    hw_forecast,
)
