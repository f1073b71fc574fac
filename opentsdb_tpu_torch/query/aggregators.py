"""The Aggregators registry.

Mirrors ``opentsdb_tpu/query/aggregators.py`` of the JAX package, copied rather
than imported: the port imports nothing of that package.

Parity: reference src/core/Aggregators.java — a name -> aggregator map with
``get``/``set`` hooks so new aggregators plug in without touching the
engine. The classic five (sum, min, max, avg, dev) keep their reference
semantics; this system adds ``count``, percentile aggregators (p50, p75,
p90, p95, p99, p999 — exact masked quantiles across series on device, or
t-digest sketches for streaming/distributed paths), and ``cardinality``
(HyperLogLog distinct count), per the north star (BASELINE.json).
"""

from __future__ import annotations

from typing import NamedTuple

from opentsdb_tpu_torch.core.const import NOLERP_AGGS


class AggSpec(NamedTuple):
    name: str
    kind: str          # 'moment' | 'percentile' | 'cardinality'
    quantile: float | None = None  # for kind == 'percentile'
    lerp: bool = True  # interpolate group-stage gaps?

    @property
    def interpolates(self) -> bool:
        """Whether group-stage gaps are lerped. The zimsum/mimmin/mimmax
        family doesn't: a series contributes only where it actually has
        a sample (the "interpolation-free" aggregators OpenTSDB added
        after the 1.1 reference; same query-language names)."""
        return self.lerp


class Aggregators:
    """Registry of aggregator specs, keyed by query-language name."""

    _registry: dict[str, AggSpec] = {}

    @classmethod
    def get(cls, name: str) -> AggSpec:
        """Look up an aggregator; raises ValueError with the unknown name
        (reference Aggregators.get throws NoSuchElementException)."""
        try:
            return cls._registry[name]
        except KeyError:
            raise ValueError(f"No such aggregator: {name}") from None

    @classmethod
    def set(cls, name: str, spec: AggSpec) -> None:
        cls._registry[name] = spec

    @classmethod
    def available(cls) -> list[str]:
        return sorted(cls._registry)


for _name in ("sum", "min", "max", "avg", "dev", "count"):
    Aggregators.set(_name, AggSpec(_name, "moment"))
for _name in NOLERP_AGGS:
    Aggregators.set(_name, AggSpec(_name, "moment", lerp=False))
for _name, _q in (("p50", 0.50), ("p75", 0.75), ("p90", 0.90),
                  ("p95", 0.95), ("p99", 0.99), ("p999", 0.999)):
    Aggregators.set(_name, AggSpec(_name, "percentile", _q))
Aggregators.set("cardinality", AggSpec("cardinality", "cardinality"))
