"""Error bounds of the sketch answers.

Mirrors ``opentsdb_tpu/sketch/bounds.py`` of the JAX package, trimmed to
what the port's routes declare: ``hll_error``, the bound ``/distinct``
reports beside a streaming HyperLogLog estimate.
"""

from __future__ import annotations

import numpy as np


def hll_error(p: int, estimate: float, nsigma: float = 3.0) -> float:
    """Absolute +-bound on an HLL cardinality estimate with 2^p
    registers (relative standard error 1.04/sqrt(m), at nsigma)."""
    m = 1 << int(p)
    return float(estimate) * nsigma * 1.04 / float(np.sqrt(m))
