"""Fault injection: the failpoint registry and the crash harness.

Mirrors ``opentsdb_tpu/fault/`` of the JAX package:

- ``faultpoints``: named failpoints at the port's durability sites (WAL
  append and fsync, WAL group commit, the three checkpoint phases,
  sstable writes, the sharded store's per-shard spill joins, the tenant
  snapshot) and at the query scan; no-ops until armed, then crash, tear,
  raise, ioerror or delay on a deterministic schedule.
- ``harness``: runs a seeded ingest / delete / checkpoint workload in a
  child process, kills it at the armed point, reopens the store in the
  parent and checks the crash-consistency invariants (fsck clean, raw
  golden parity, tenant accounting) against an in-memory oracle, and
  shrinks a failing schedule to a smaller repro.
"""
