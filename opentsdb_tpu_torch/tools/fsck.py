"""Storage fsck as a library: the CLI's ``fsck`` subcommand and the crash
harness share one implementation, so the crash matrix's "fsck clean"
invariant runs the operator tool itself.

Mirrors ``opentsdb_tpu/tools/fsck.py`` of the JAX package, with the same
checks and counts (parity: the reference's src/tools/Fsck.java, plus the
local format's audits):

- qualifier framing (non-empty, even length) and value decode;
- duplicate or out-of-order timestamps inside compacted cells;
- whole-row compactability (conflicting duplicate points across cells);
- sstable series blooms: a false negative (an indexed key its own table's
  bloom excludes) would hide rows from bloom-pruned scans, a hard error;
- TSST4 blocks: every block's codec tag known, its payload decoding, its
  decoded size matching the header (``codec_errors``), with the blocks
  counted per codec (``codec_counts``). A data scan that a corrupt block
  cuts short counts one codec error instead of crashing.

``fix=True`` salvages rows (explode what decodes, keep the first value per
delta, rewrite); the CLI's ``--expect-clean`` maps any error to a distinct
exit code. Each run lands one ``fsck.duration`` observation in the
metrics registry (``obs/registry.py``). Left out: the rollup tier's
stores (ROADMAP queue A item 6).
"""

from __future__ import annotations

import dataclasses

from opentsdb_tpu_torch.compress.codecs import CODEC_NAMES, BlockCodecError
from opentsdb_tpu_torch.core import codec
from opentsdb_tpu_torch.core.errors import IllegalDataError
from opentsdb_tpu_torch.core.tsdb import FAMILY
from opentsdb_tpu_torch.obs.registry import METRICS

# One observation per fsck run: tsd.fsck.duration (p50/p95/p99 and
# .count/.sum_ms). The crash harness asserts that a sample lands during
# its recovery check.
_M_FSCK = METRICS.timer("fsck.duration")


@dataclasses.dataclass
class FsckReport:
    kvs: int = 0
    rows: int = 0
    errors: int = 0
    fixed: int = 0
    bloomed: int = 0        # sstables carrying at least one bloom
    plain: int = 0          # bloomless or legacy-format sstables
    bloom_misses: int = 0   # bloom false negatives (counted in errors)
    # Generation count per sstable format version.
    format_counts: dict = dataclasses.field(default_factory=dict)
    blocks: int = 0         # TSST4 blocks audited
    # Block-level failures (counted in errors): unknown codec tag, decode
    # failure, or uncompressed-size mismatch.
    codec_errors: int = 0
    # Blocks per codec name.
    codec_counts: dict = dataclasses.field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return self.errors == 0


def run_fsck(tsdb, fix: bool = False, log=None) -> FsckReport:
    """Scan the data table and audit the sstable blooms; returns the
    report. ``log`` (a callable) receives one line per finding; None is
    silent."""
    with _M_FSCK.time():
        return _run_fsck(tsdb, fix, log)


def _scan_rows(tsdb, rep: FsckReport, say):
    """The batched row scan (the JAX fsck reads per row through
    ``scan``: the same rows, each row's cells in qualifier order). A
    corrupt compressed block raises mid-iteration and ends the scan: it
    counts here, and the per-generation block audit pinpoints it."""
    it = tsdb.store.scan_raw(tsdb.table, b"", b"", family=FAMILY)
    while True:
        try:
            row = next(it)
        except StopIteration:
            return
        except (BlockCodecError, IOError) as e:
            rep.errors += 1
            rep.codec_errors += 1
            say(f"ERROR: data scan aborted by unreadable storage: {e}")
            return
        yield row


def _run_fsck(tsdb, fix: bool, log) -> FsckReport:
    say = log if log is not None else (lambda *_: None)
    rep = FsckReport()
    for key, cells in _scan_rows(tsdb, rep, say):
        rep.rows += 1
        bad = False
        for qual, val in cells:
            rep.kvs += 1
            if len(qual) == 0 or len(qual) % 2 != 0:
                rep.errors += 1
                bad = True
                say(f"ERROR: row {key.hex()}: odd qualifier length "
                    f"{len(qual)}")
                continue
            try:
                points = codec.explode_cell(qual, val)
            except IllegalDataError as e:
                rep.errors += 1
                bad = True
                say(f"ERROR: row {key.hex()}: {e}")
                continue
            if codec.is_compacted_qualifier(qual):
                # A compacted cell's deltas must be strictly increasing;
                # compact_cells sorts before checking, so in-cell
                # duplicates or disorder would pass without this.
                deltas = [c.delta for c in points]
                for j in range(1, len(deltas)):
                    if deltas[j] == deltas[j - 1]:
                        rep.errors += 1
                        bad = True
                        say(f"ERROR: row {key.hex()}: compacted cell "
                            f"has duplicate timestamp (delta="
                            f"{deltas[j]}, qualifier #{j})")
                    elif deltas[j] < deltas[j - 1]:
                        rep.errors += 1
                        bad = True
                        say(f"ERROR: row {key.hex()}: compacted cell "
                            f"has out-of-order timestamps (delta="
                            f"{deltas[j]} after {deltas[j - 1]}, "
                            f"qualifier #{j})")
        # A lone cell that decoded with strictly increasing deltas cannot
        # conflict with itself: only rows of several cells can fail the
        # whole-row merge (the JAX fsck merges every row; same findings).
        if not bad and len(cells) > 1:
            try:
                codec.compact_cells(cells)
            except IllegalDataError as e:
                rep.errors += 1
                bad = True
                say(f"ERROR: row {key.hex()}: {e}")
        if bad and fix:
            rep.fixed += _fix_row(tsdb, key, cells)
    # The series-bloom and block audits over every generation of every
    # shard.
    stores = list(getattr(tsdb.store, "shards", None) or [tsdb.store])
    for s in stores:
        for sst in getattr(s, "_ssts", []):
            fmt = getattr(sst, "format", 3)
            rep.format_counts[fmt] = rep.format_counts.get(fmt, 0) + 1
            any_bloom = False
            for name in sst.tables():
                miss = sst.bloom_check(name)
                if miss is None:
                    continue
                any_bloom = True
                if miss:
                    rep.errors += miss
                    rep.bloom_misses += miss
                    say(f"ERROR: {sst.path}: series bloom for table "
                        f"'{name}' excludes {miss} of its own keys")
            rep.bloomed += 1 if any_bloom else 0
            rep.plain += 0 if any_bloom else 1
            if sst.block_count:
                rep.blocks += sst.block_count
                for j in range(sst.block_count):
                    try:
                        tag = sst.block_header(j)[0]
                    except Exception:
                        continue    # block_audit reports it below
                    name = CODEC_NAMES.get(tag, f"tag{tag}")
                    rep.codec_counts[name] = \
                        rep.codec_counts.get(name, 0) + 1
                bad = sst.block_audit(say)
                rep.codec_errors += bad
                rep.errors += bad
    return rep


def _fix_row(tsdb, key: bytes, cells) -> int:
    """Salvage one row's (qualifier, value) cells: explode what decodes,
    keep the first value per delta, rewrite."""
    points: dict[int, codec.Cell] = {}
    for qual, val in cells:
        if len(qual) == 0 or len(qual) % 2 != 0:
            continue
        try:
            for c in codec.explode_cell(qual, val):
                points.setdefault(c.delta, c)
        except IllegalDataError:
            continue
    if not points:
        tsdb.store.delete_row(tsdb.table, key)
        return 1
    ordered = [points[d] for d in sorted(points)]
    qual, val = codec.merge_cells(ordered)
    tsdb.store.delete_row(tsdb.table, key)
    tsdb.store.put(tsdb.table, key, FAMILY, qual, val)
    return 1
