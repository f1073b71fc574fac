"""Multi-tenant cardinality control plane.

Mirrors ``opentsdb_tpu/tenant/`` of the JAX package:

- accounting.py: per-tenant series-cardinality tracking (exact set
  below a cutoff, HLL register bank above it), SpaceSaving heavy-hitter
  summaries of the hottest series and the series-heaviest metric
  prefixes, snapshotted to ``<wal>.tenants.json`` through the
  checkpoint bracket.
- limits.py: per-tenant (and global) series caps enforced at
  add_point/add_batch admission — a NEW series from an over-budget
  tenant refuses with a declared error; existing series keep ingesting.
"""
