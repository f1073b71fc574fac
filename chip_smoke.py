"""Smoke run of the PyTorch/CUDA port (opentsdb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every kernel of ``opentsdb_tpu_torch/csrc`` with nvcc for sm_90a
   (one nvcc per source, all started together), and beside them the
   native ingest extension and telnet decoder of
   ``opentsdb_tpu_torch/native`` with gcc and g++ (``utils/nativeext.py``).
3. Kernel phase: holds each CUDA kernel against its plain PyTorch version
   on the card, at the shapes the two query paths give it (the window's
   chunk fold, the scan path's series stage, once more with its points
   randomly permuted so unsorted ids are held at scale too, and the group
   stages both share), and times the kernel, the plain version and the
   one-call library yardstick with CUDA events (median of 20 runs),
   beside the least time the card needs for the bytes and operations.
   The kernel is timed three ways: as it comes (inputs may sit in the
   50 MB L2; the clock starts on an idle card, so the wrapper's host time
   counts), cold (a 128 MB buffer written before each run: device time
   with a cold L2, the wrapper's host time hidden behind that write), and
   as device time alone with a warm L2 (20 runs queued back to back behind
   a GPU sleep). Compare cold with the last, not with the first. The
   rank-select kernel is held the same way on the window's sum:1h-avg
   stage grid (columns at one quantile and at three; grouped by dc and by
   host) and on the contributions of an un-downsampled p95 over
   {dc=dc0}'s first day (yardstick for the columns cases: one
   torch.nanquantile); the interpolate-and-reduce kernel on that day's
   union grid (against its plain composition) and on all series for the
   week (~302k grid points; the plain composition does not fit whole, so
   at 256 grid points drawn with a seed the kernel is held against it and
   its sums against float64). The details line records each select
   case's launch plan (cluster width, clusters the card co-schedules,
   rows staged per block) and interp_moments' tile. The sketch kernels
   (``csrc/sketches.cu``) the same way, at the daemon's shapes: the
   t-digest fold of one hand-off of ``Config.sketch_flush_points`` (1,049
   series x 1,000 values) and of the 4096-value chunk, the HLL fold of
   one hand-off's host and dc UIDs and of all the corpus' at p = 12, of
   dc0's hosts at p = 14, of the hand-off's hosts in four rows that name
   one slot, and of every host and dc again into the stack they raised
   (the steady-state re-fold), the estimate over the p = 12 stack, and
   the merged quantile over all 10,000 digests (S = 16,384 rows,
   2,097,152 entries); folds and registers exact against their plain
   versions, estimates within rtol 1e-6, quantiles within rtol 1e-4 (and
   the same on every run). Beside them the card's launch floor: an empty
   kernel launched the way the sketch wrappers launch theirs, timed the
   same three ways, and the host's time in each step of a wrapper call.
4. Path phase: starts the port's daemon on loopback as ``tsdb tsd`` does
   (``tools/cli.py``: the default settings, so the resident device window,
   the live sketches and tenant accounting on, and the heap frozen out of
   cycle collection once the store is open; the collections during ingest
   and their pauses are recorded), ingests the repo's benchmark
   corpus (10,000 series x 1,000 points over 7 days = 10M points,
   bench.py gen_workload's shape) through ``TSDB.add_batch`` plus a few
   hundred telnet ``put`` lines, then answers ten ``/q`` queries over
   HTTP (five moment and five percentile group aggregators), each once
   cold (the first run of a (range, interval, downsample) key builds the
   window's chunk stage) and WARM_REPS times warm. Every answer must say
   ``"rollup": "resident"`` and raise the window's hit count by one: a
   query that falls back to the scan fails; every run of a percentile
   query must launch the rank select. Then four queries without a
   downsampler over HTTP, which the window declines (``"rollup": "raw"``):
   ``sum`` over every series for the week, ``zimsum`` and ``p95`` of
   ``{dc=dc0}`` over the first day, ``sum:rate`` of one host over the
   week; each must launch interp_moments (the percentile: the select).
   No checkpoint has run yet, so every chunk of the week holds memtable
   rows: the fragment cache must have bypassed every chunk (no hit, no
   miss, every answer ``"cached": false``); the counters are printed.
   Before those, right after ingest (the live sketches fold every value:
   the ingest rate is printed beside the smoke's earlier figure, taken
   before the sketches were ported, and the
   sketches' hand-offs, fold calls, state bytes and final drain), the
   sketch routes over HTTP: ``/sketch`` p50/p95/p99 over every series,
   ``{dc=dc0}`` and ``{host=h00001}``, each within SKETCH_RANK_TOL in rank
   of the exact float32 values of those series; ``/distinct`` of host and
   dc (streaming) within ``hll_error`` of 10,020 and 10; a ranged
   ``/sketch`` over ``{dc=dc0}`` (``"rollup": "raw"``, equal to the exact
   quantiles) and a ranged ``/distinct`` with ``tags=dc=dc0`` (the HLL
   kernel at p = 14) within ``hll_error`` of 1,002. The four sketch
   kernels' launch counts are set to 0 before ingest and read after these
   queries: each must have launched. Then HTTP ingest: 200 new series x
   1,000 points through ``/api/put?tenant=smoke``, half as JSON bodies and
   half as put lines, in bodies of at most 10,000 points (timed: the HTTP
   ingest rate), and the same points through telnet on the connection's
   tenant ``smoke-telnet`` under another metric; ``sum:1h-avg`` and
   ``max:1h-max`` of each by host must agree (the max exactly), and
   ``/api/tenants`` must show ``default`` (the corpus and the telnet
   series, 10,020) in the HLL tier within 3 standard errors, the two new
   tenants at exactly 200 in the exact tier, and ``bench.metric`` as the
   top prefix.
   Then, in process: each query's chunk-stage time and apply-and-fetch
   time (synchronised); one host scan of every series over the week
   (timed), whose spans, regrouped as a scan with each query's filter
   groups them, feed the same five queries on the port's scan path on
   the same TSDB (window set aside; device stage timed), each answer held
   against the resident one, and both against the float64 oracle
   (``ops/oracle.py``); the same spans hold the percentile answers
   against the scan path's kernels and the float64 oracle (the oracle
   downsamples each series once), and the un-downsampled answers against
   the oracle (the full-width sum at 256 sampled grid points). One scan
   serves them all, to keep the run's time down.
   one warm resident query and one stage build under ``torch.profiler``
   for the device-busy share. Each path (the resident HTTP queries, the
   un-downsampled HTTP queries, the scan loop) is driven with the kernel
   launch counts set to 0 just before it and read just after; a stage
   build and each scan-path query must launch ``segment_sum``, the
   resident path its three kernels, the scan loop both segment kernels
   and the un-downsampled path interp_moments and masked_select.
   The daemon's host path runs through the native C where the JAX
   package's does: with the sites' call counts set to 0 before and read
   after, the corpus ingest must call ``slice_cells``, ``slice_keys`` and
   ``upsert_cells``, and the telnet lines and the ``/api/put`` bodies
   ``tsd_parse`` (the decoder) and ``upsert_cells`` too.
5. Restart phase, on the path phase's daemon and corpus at full width:
   first a copy of the WAL (every put so far, nothing spilled yet) is
   replayed into a bare store, timed (the recovery a crash would pay; it
   must call ``slice_varlen`` and ``upsert_cells`` and hold the
   memtable's row keys), then ``TSDB.checkpoint()`` spills the ingested store to its first sstable
   generation (rows, generation bytes and seconds printed); a few hundred
   telnet ``put`` lines add 20 series (one point per series and hour, so
   their sums are exact in any order); the ten resident queries must still
   answer ``"rollup": "resident"`` (their answers are the reference below);
   a second checkpoint makes two generations. Each checkpoint must frame
   its records in C (``frame_rows_dict``), the telnet puts between them
   must call ``rows_update_new`` (their rows lie inside the generation's
   key range: the bulk branch that probes the tiers). The daemon shuts
   down (which checkpoints once more), and a new TSDB and daemon open the
   same WAL: opening the generations (their footer keys sliced in C,
   ``slice_varlen``), replaying ``<wal>.old`` and the WAL, and the
   window's warm-up from the tiers are timed apart. With the launch counts
   set to 0, the ten queries run once cold and WARM_REPS times warm: each
   must be resident, the path must launch segment_sum, segment_minmax and
   masked_select, and each answer must equal the reference (max and the
   percentiles exactly, the sums within the resident tolerance). Then
   ``sum:rate`` of ``{host=h00001}`` over the week without a downsampler,
   read from the generations, must launch interp_moments and match the
   float64 oracle, and one host scan of every series over the week from
   the generations is timed beside the path phase's scan of the memtable,
   then timed again from the fragment cache it filled (its spans must
   equal the cold scan's array for array). The memtable is empty here, so
   every chunk is clean: the scan fast path runs at full width. The
   ``{host=h00001}`` query's chunk scans must skip every generation whose
   series bloom lacks that host (checkpoint 2's holds only the telnet
   u-series), and ``bloom_files_skipped`` must rise then. That query, and
   ``zimsum`` and ``p95`` of ``{dc=dc0}`` over the first day, run a second
   time: each repeat must say ``"cached": true``, carry the first run's
   bytes but for that flag, and launch its kernel again; the ranged
   ``/sketch`` and ``/distinct`` of ``{dc=dc0}`` run again and must answer
   the same bytes. The hit, miss and bypass counts, the bloom skips and
   what the fragment cache holds (entries, points, bytes of host RAM) are
   printed.
   The sketch snapshot's save (inside checkpoint 1) and load (at boot)
   are timed, and after the restart every sketch route answers byte for
   byte as before it (the state is the snapshot: the memtable is empty),
   launching the HLL fold, the estimate and the merged quantile. So is
   the tenant snapshot's (its bytes too): the new daemon must load it,
   not rebuild, and answer ``/api/tenants`` as before the restart but for
   the count of snapshots written. The full ``gc.collect()`` is timed
   with the memtable live and after the restart, each daemon's heap
   frozen at its open. Last, the store's tenant file is replaced by the
   version-0 file the port wrote before it kept accounting: a new open
   must rebuild from all of storage (timed) with exact totals, and its
   checkpoint must write a real snapshot.
   (The card's machine has no JAX, so the crossings with the JAX package's
   store directories run only in the CPU tests,
   ``tests/test_torch_checkpoint.py``.)
5b. Sharded phase: the daemon over a SHARDS-shard store
   (``storage/sharded.py``, ``tsdb tsd --shards 4 --wal-group-ms 2``)
   ingests the same corpus (as wire batches of BARRIER_SERIES series:
   ``sync=False`` per series, one covering ``wal_barrier()`` per batch),
   the telnet lines and the ``/api/put`` phase (its native stages under
   ``sharded_``); the ten resident and the four un-downsampled answers
   must equal the one-shard daemon's from the path phase (REFERENCE:
   tags and timestamps identical, max and percentiles exactly, sums at
   the resident tolerance; how many are the same JSON is counted), and
   each path must launch its kernels. Checkpoint 1 spills everything
   (total and per-shard seconds); checkpoint 2 runs while a writer thread
   adds WRITER_SERIES series (the longest ``add_batch`` during it is the
   pause a writer saw). The daemon shuts down and a new one opens the
   directory by its ``SHARDS.json`` (boot seconds, the tenant snapshot
   loaded, not rebuilt); the resident answers and ``sum:rate`` of
   ``{host=h00001}`` again, the cold ``{host=*}`` week
   scan, ``{host=h00001}``'s ``bloom_shards_skipped`` (a positive
   multiple of SHARDS - 1: its one series routes to one shard) and
   ``tools/fsck.run_fsck`` clean, as on the one-shard store at the end of
   the restart phase. Then the 1-vs-SHARDS A/B with group commit off:
   the corpus' first PAUSE_SERIES series through ``add_batch`` into a
   1-shard and a SHARDS-shard store (the ingest rate of each), each then
   checkpointed while a writer ingests (the pause it sees over a full
   memtable).
5d. Compressed phase (``compress/``), after the path phase, at full
   width: a daemon with ``sstable_codec="tsst4"``, the resident window
   off (it would answer first) and otherwise the default Config ingests
   the corpus, its telnet series and INT_SERIES integer series over telnet
   (``bench.int``, the TSINT leg), then checkpoint 1 (seconds, rows/s, v4
   bytes beside the path phase's v3 ones, ``compress.ratio`` from
   ``/stats``). The block-decode kernel (``csrc/block_decode.cu``) is held
   bit for bit against ``decode_points_plain`` on the card and timed like
   the others at three shapes from the store's own gathers: the week of
   ``bench.metric`` (TSF32), one day of it, and the week of ``bench.int``
   (TSINT), and on a synthetic gather of 10-second records (360 points a
   record, 10M points, from a seed: records that cross tile edges); a
   child process counts, under ``torch.profiler``, the kernels and
   memsets of one decode at each case's size (at most
   DECODE_MAX_KERNELS kernels, no memset). With the
   launch counts set to 0, the ten ``/q`` queries run
   once cold and FUSED_WARM_REPS times warm over HTTP: every group must
   say ``"rollup": "fused"`` and each answer must match the path phase's
   (REFERENCE, the resident tolerance) and the float64 oracle's; the path
   must launch block_decode, segment_sum and (the percentiles)
   masked_select. One ``bench.int`` query must equal the raw scan's
   answer exactly. Then one day of ``sum:1h-avg`` through each leg, cold
   and warm: the byte-stream leg (device block cache off), the cache's
   miss and its hit, and ``max:1h-max{host=h00001}``'s selector legs; the
   gather's host time with the blocks' parsed keys dropped and kept; the
   decode kernels' share of a cold ``sum:1h-avg``'s card time under the
   profiler; the
   ``/api/queries`` fused section. A telnet put of another metric into a
   covered hour must make the next query decline ``dirty`` (counted) and
   be served raw with the same answer. Checkpoint 2, then a restart on the
   WAL: the ten queries fused again, max and percentiles byte for byte,
   the sums within the resident tolerance, and fsck of the v4 store with
   its per-codec block counts and no codec error.
5c. Observability (``obs/``), on the path phase's daemon at full width
   before the restart: one resident and one scan ``/q?trace=1`` (the
   ``{dc=dc0}`` day's ``zimsum``); each span tree must have the names and
   plan tags the JAX daemon gives for that plan (resident: the root over
   one ``planner.pick``; scan: ``planner.pick``, ``scan`` with its
   fragment-cache tags over ``chunk.decode`` spans, ``aggregate``), and
   every span's children must sum to at most its own wall time. Each is
   run once more under ``torch.profiler``: its spans' ms print beside the
   card's busy ms. The resident query alternates untraced and traced
   warm runs (the cost of tracing). ``/stats``, ``/stats?json``,
   ``/metrics`` (valid Prometheus text), ``/logs``, ``/api/traces``,
   ``/api/queries`` and the telnet ``stats`` command must answer. The
   sharded phase traces the same scan query over its 4 shards (one
   ``shard.scan`` span per shard under each ``chunk.decode``) and takes
   its two checkpoints' ``checkpoint.phase`` and ``checkpoint.shard_spill``
   split from the daemon's ``/stats``; the restart phase's daemon gives the
   ``wal.append``, ``wal.fsync``, ``ingest.parse`` and ``checkpoint.phase``
   percentiles (process-wide since the smoke began). One ``obs`` stdout
   line carries these.
6. Refusal phase: a small second daemon on the card with
   ``tenant_max_series=1`` must refuse a new series over telnet (the bulk
   path's and the per-line path's declared lines) and over ``/api/put``
   (the 429 body naming the limit), while its existing series keeps
   ingesting.
7. Window-at-budget phase: a ``DeviceWindow`` filled directly to the
   default budget, 2^26 points (16,384 series x 4,096 points over 7 days,
   appended per series); its chunk stage and apply for ``sum:1h-avg`` and
   ``max:1h-max`` timed with CUDA events beside the stage's byte bound and
   held against the same functions on CPU tensors; then one more staging
   batch must evict the oldest chunk, advance ``complete_from`` and turn a
   query reaching before it away.
8. Prints the card line first; at the end the per-query, sketch,
   ingest, profiler, tenants, restart, native (build seconds and calls
   per C site, per stage, and the WAL replay), sharded, obs, budget and
   launch-floor lines, the compressed line, the
   kernels
   line (nine
   kernels) and, last, the ok line.
   In the kernels line each kernel's top-level numbers are its first
   path's: the segment kernels' and the select's the resident path's
   (at the chunk-fold shape and the columns select at one quantile),
   interp_moments' the un-downsampled path's (at the one-day {dc=dc0}
   shape; its full-width numbers under ``full_width``), the sketch
   kernels' the sketch path's (their other shapes under
   ``other_cases``). Under ``paths``
   each path's launches stand beside the times at its own shape (the scan
   path's: the series stage; the select's un-downsampled path: the p95
   contributions). Counts include the group stages' launches, whose times
   are in the details line.

Any failure raises and exits nonzero before the last line. Without a CUDA
card, or without the package beside it, it exits nonzero and prints no
result. The full details go to standard error as one JSON line.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import http.client
import itertools
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse

import numpy as np
import torch

from opentsdb_tpu_torch.compress import fused as cfused
from opentsdb_tpu_torch.compress.devcache import pad_fine
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.obs.registry import METRICS
from opentsdb_tpu_torch.ops import (block_decode, cuda_build, interp_moments,
                                    kernels as wk, masked_select, oracle,
                                    segment_reduce, sketches)
from opentsdb_tpu_torch.query.aggregators import Aggregators
from opentsdb_tpu_torch.query.executor import (QueryExecutor, QueryResult,
                                               QuerySpec, _filter_key,
                                               _pad64, _pad_size, _Span)
from opentsdb_tpu_torch.query.grammar import parse_m
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.sketch.bounds import hll_error
from opentsdb_tpu_torch.stats.livesketch import LiveSketches
from opentsdb_tpu_torch.stats.livesketch import _pad as _sk_pad
from opentsdb_tpu_torch.storage.devstore import DeviceWindow
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.tenant.accounting import hll_rel_error
from opentsdb_tpu_torch.tools.cli import open_tsdb
from opentsdb_tpu_torch.tools.compare_kernels import decode_inputs
from opentsdb_tpu_torch.tools.fsck import run_fsck
from opentsdb_tpu_torch.utils import nativeext
from opentsdb_tpu_torch.utils.config import Config
from opentsdb_tpu_torch.utils.gctune import tune_for_ingest

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 128 << 20    # written between cold runs: > the 50 MB L2
BASE = 1356998400             # hour-aligned epoch, as bench.py
SERIES, POINTS, SPAN = 10_000, 1_000, 7 * 86400
TELNET_SERIES, TELNET_POINTS = 20, 20
INTERVAL = 3600
QUERIES = ["sum:1h-avg:bench.metric",
           "sum:1h-avg:bench.metric{dc=*}",
           "max:1h-max:bench.metric{host=h00001}",
           "dev:1h-avg:bench.metric",
           "sum:rate:1h-avg:bench.metric"]
# Percentile group aggregators, served from the window like the moments
# (the three share sum:1h-avg's stage).
PCT_QUERIES = ["p50:1h-avg:bench.metric",
               "p95:1h-avg:bench.metric",
               "p99:1h-avg:bench.metric",
               "p95:1h-avg:bench.metric{dc=*}",
               "p95:1h-avg:bench.metric{host=*}"]
DAY = 86400
# Queries without a downsampler (the window declines them: plan "raw"),
# each with the length of its range from BASE.
UNION_QUERIES = [("sum:bench.metric", SPAN),
                 ("zimsum:bench.metric{dc=dc0}", DAY),
                 ("p95:bench.metric{dc=dc0}", DAY),
                 ("sum:rate:bench.metric{host=h00001}", SPAN)]
WARM_REPS = 5                 # warm /q runs per query, after the first
# Restart phase: telnet series added between its two checkpoints, each
# with one point in each of EXTRA_POINTS distinct hours (one point per
# series and 1h bucket: their sums are exact in any order).
EXTRA_SERIES, EXTRA_POINTS = 20, 15
# Restart phase's un-downsampled query over the generations.
RESTART_UNION = "sum:rate:bench.metric{host=h00001}"
DEVICE = "cuda"
STAGING = 1 << 20             # Config device_window_staging
# The window's first chunk at the smoke's ingest: whole 1,000-point
# series batches until the staging threshold is crossed.
FOLD_POINTS = -(-STAGING // POINTS) * POINTS
# Window-at-budget phase: the default resident budget (Config
# device_window_points), as 16,384 series x 4,096 points over SPAN.
BUDGET_SERIES, BUDGET_POINTS = 16_384, 4_096
# Sketch routes: the quantiles asked, and how far in rank (share of the
# exact values) a t-digest answer may lie from its quantile. The digests
# hold 128 centroids: the merged digest of 10,020 series is itself
# compressed to 128, whose k1 clusters near the median each hold ~1.2% of
# the weight; an answer interpolated inside one lands within half that.
SKETCH_QS = [0.5, 0.95, 0.99]
SKETCH_RANK_TOL = 0.01
# The ingest rate of this smoke's last run before the live sketches folded
# at ingest (PERF.md; NVIDIA H100 80GB HBM3, 700 W).
INGEST_WITHOUT_SKETCHES_POINTS_PER_S = 531446.9595197901
# HTTP ingest (/api/put): new series of HTTP_POINTS points each, half of
# them posted as JSON bodies and half as put lines, under ?tenant=smoke,
# in bodies of at most HTTP_BODY_POINTS points (a JSON point takes ~80
# bytes; the daemon takes bodies up to 1 MiB). The same points go through
# telnet, on the tenant TELNET_TENANT, under another metric.
HTTP_SERIES, HTTP_POINTS, HTTP_BODY_POINTS = 200, 1_000, 10_000
HTTP_TENANT, TELNET_TENANT = "smoke", "smoke-telnet"
HTTP_QUERIES = ["sum:1h-avg:{m}{{host=*}}", "max:1h-max:{m}{{host=*}}"]
# The full gc.collect() this smoke measured before the daemon froze its
# heap (PERF.md; NVIDIA H100 80GB HBM3, 700 W): with the memtable live,
# and after the restart.
GC_FULL_MS_UNTUNED = {"memtable": 283.1, "after_restart": 209.3}
# The version-0 tenant file each checkpoint of the port wrote before it
# kept tenant accounting; an open must rebuild from storage over it.
OLD_TENANT_MARKER = {"version": 0, "written_by": "opentsdb_tpu_torch",
                     "note": "this store keeps no tenant accounting; "
                             "rebuild it from storage"}


# Calls per native C site in each stage of the daemon's path (native_calls).
NATIVE_STAGES: dict = {}
# The sharded phase: the store's shard count and WAL group-commit window
# (ms), the series per covering barrier of its corpus ingest (a wire
# batch's shape), and the writer that ingests while checkpoints run.
SHARDS, WAL_GROUP_MS, BARRIER_SERIES = 4, 2.0, 100
WRITER_SERIES, WRITER_POINTS = 1_000, 1_000
# The one-shard daemon's answers (path phase, before any checkpoint) and
# the float64 oracle's answers to its ten downsampled queries: the sharded
# and compressed phases' reference.
REFERENCE: dict = {}
# The writer-pause A/B's corpus: its first PAUSE_SERIES series (a quarter,
# to keep the smoke inside its time limit).
PAUSE_SERIES = 2_500
# Compressed phase: integer series through telnet (bench.int, one point
# every INT_STEP seconds over the week: the TSINT leg; one point per
# row-hour, so each row is one cell whichever telnet batch carried it, as
# the columnar codecs need), warm /q runs per query after the first.
INT_SERIES, INT_STEP = 200, 3600
# The decode kernel's synthetic long-record gather (compare_kernels'
# decode_inputs: 10-second scrapes, 360 points a record hour, blocks of
# 120 records, about BLOCK_RAW_TARGET raw bytes).
LONG_RECORD_GATHER_POINTS = 10_000_080
DECODE_MAX_KERNELS = 3
FUSED_WARM_REPS = 2
NO_LIBRARY = "no single PyTorch call computes this function"


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@contextlib.contextmanager
def native_calls(stage: str, need: tuple[str, ...]):
    """Set the native sites' call counts to 0, run the stage, keep its
    counts under ``stage`` and fail if a site in ``need`` was not called:
    the daemon's path must run through the C where the JAX package's
    does."""
    nativeext.reset_calls()
    yield
    got = NATIVE_STAGES[stage] = dict(nativeext.calls)
    missing = [site for site in need if got[site] == 0]
    if missing:
        fail(f"{stage}: the native site(s) {missing} were never called "
             f"({got})")


def median_ms(fn, reps: int = 20, flush: torch.Tensor | None = None) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one
    warm-up run. With ``flush``, that buffer is written before each run,
    outside the events, so every run starts with a cold L2; the write is
    still running when ``fn`` is called, so the host's time in ``fn`` up to
    its launch is hidden and the result is device time alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs queued
    behind a GPU sleep, so the host's time in the wrapper overlaps the
    device's work instead of adding to it (``median_ms`` starts its clock
    on an idle card and so counts the host's time to the first launch)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)   # ~5 ms at H100 clocks: room to queue
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work: bytes over HBM rate vs operations over
    the float32 peak, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# Corpus
# ---------------------------------------------------------------------------

def corpus(seed: int = 0):
    """bench.py gen_workload's corpus, drawn in bulk: regularly jittered
    timestamps (step = span / points, jitter < step / 2, so each row is
    strictly increasing) and random-walk float32 values from 100."""
    rng = np.random.default_rng(seed)
    step = SPAN // POINTS
    ts0 = np.arange(POINTS, dtype=np.int64) * step
    jitter = rng.integers(0, step // 2, (SERIES, POINTS))
    ts = BASE + np.minimum(ts0[None, :] + jitter, SPAN - 1)
    vals = (np.cumsum(rng.normal(0, 1.0, (SERIES, POINTS)), axis=1)
            + 100.0).astype(np.float32)
    return ts, vals


def series_tags(s: int) -> dict:
    return {"host": f"h{s:05d}", "dc": f"dc{s % 10}"}


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(ts: np.ndarray, vals: np.ndarray) -> list:
    """Each kernel against its plain version at the paths' shapes: the
    resident window's fold of its first chunk for a 1h downsample
    (_chunk_fold: N = 1,049,000 points into 16384 x 256 + 1 segments,
    K = 2 count + value columns for segment_sum, the value column for
    max), the scan path's series stage of a 1h downsample over the whole
    corpus (N = 10M points, K = 3, same segments), the same with the
    points randomly permuted, the group stage of a 10-dc group-by (16384 rows of
    [in_range | value | mask] x 256 buckets into 16 groups), and that of a
    ``{host=*}`` group-by, laid out as the executor lays it out: one series
    per group, gmap sorted, the 6384 padding rows (empty: zero sums, -inf
    for max) all in the last of 16384 groups. segment_minmax is timed as
    the path calls it, for one output (max)."""
    dev = torch.device(DEVICE)
    S, B = 16384, 256
    nseg = S * B + 1
    rel = (ts - BASE).reshape(-1)
    bucket = rel // INTERVAL
    sid = np.repeat(np.arange(SERIES), POINTS)
    seg = torch.from_numpy((sid * B + bucket).astype(np.int32)).to(dev)
    v = torch.from_numpy(vals.reshape(-1)).to(dev)
    feat = torch.stack([
        torch.ones_like(v), v,
        torch.from_numpy((rel - bucket * INTERVAL).astype(np.float32))
        .to(dev)], dim=1)
    perm = torch.from_numpy(
        np.random.default_rng(3).permutation(seg.numel())).to(dev)
    rng = np.random.default_rng(1)
    rows = np.zeros((S, 3 * B), np.float32)
    rows[:SERIES, :B] = 1.0
    rows[:SERIES, B:2 * B] = 100 + rng.normal(0, 5, (SERIES, B))
    rows[:SERIES, 2 * B:] = 1.0
    gmap_np = np.full(S, 15, np.int32)
    gmap_np[:SERIES] = np.arange(SERIES) % 10
    rows_t = torch.from_numpy(rows).to(dev)
    gmap = torch.from_numpy(gmap_np).to(dev)
    host_gmap_np = np.full(S, S - 1, np.int32)
    host_gmap_np[:SERIES] = np.arange(SERIES)
    host_gmap = torch.from_numpy(host_gmap_np).to(dev)
    host_max = rows_t[:, B:2 * B].clone()
    host_max[SERIES:] = float("-inf")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    v1 = v[:, None].contiguous()
    fold = feat[:FOLD_POINTS, :2].contiguous()
    cases = [
        ("segment_sum", "window chunk fold", fold, seg[:FOLD_POINTS], nseg),
        ("segment_sum", "series stage", feat, seg, nseg),
        ("segment_sum", "series stage, permuted", feat[perm], seg[perm],
         nseg),
        ("segment_sum", "group stage", rows_t, gmap, 16),
        ("segment_sum", "group stage {host=*}", rows_t, host_gmap, S),
        ("segment_minmax", "window chunk fold", v1[:FOLD_POINTS],
         seg[:FOLD_POINTS], nseg),
        ("segment_minmax", "series stage", v1, seg, nseg),
        ("segment_minmax", "series stage, permuted", v1[perm], seg[perm],
         nseg),
        ("segment_minmax", "group stage", rows_t[:, B:2 * B].contiguous(),
         gmap, 16),
        ("segment_minmax", "group stage {host=*}", host_max, host_gmap, S),
    ]
    results = []
    for name, stage, x, ids, ns in cases:
        n, k = x.shape
        if name == "segment_sum":
            got = segment_reduce.segment_sum(x, ids, ns)
            want = segment_reduce.segment_sum_plain(x, ids, ns)
            torch.cuda.synchronize()
            if not stage.startswith("group stage"):
                # Counts and bucket-relative timestamp sums are integral
                # and below 2^24: exact. Value sums: float32, another
                # (run-dependent) order: rtol 1e-5.
                if not torch.equal(got[:, 0], want[:, 0]) \
                        or not torch.equal(got[:, 2:], want[:, 2:]):
                    fail(f"{name} {stage}: integral sums differ")
                torch.testing.assert_close(got[:, 1], want[:, 1],
                                           rtol=1e-5, atol=1e-5)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            err = float((got - want).abs().max())

            def library(x=x, ids=ids, ns=ns):
                return torch.zeros((ns, x.shape[1]), device=dev) \
                    .index_add_(0, ids, x)

            def fn(x=x, ids=ids, ns=ns):
                return segment_reduce.segment_sum(x, ids, ns)

            def plain(x=x, ids=ids, ns=ns):
                return segment_reduce.segment_sum_plain(x, ids, ns)
        else:
            # Min and max: exact, for each output alone and for both.
            mn, mx = segment_reduce.segment_minmax_plain(x, ids, ns)
            want = (mn, mx, mn, mx)
            got = (*segment_reduce.segment_minmax(x, ids, ns),
                   segment_reduce.segment_minmax(x, ids, ns, need="min"),
                   segment_reduce.segment_minmax(x, ids, ns, need="max"))
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                if not torch.equal(a, b):
                    fail(f"{name} {stage}: min/max not exact")
            err = max(float((a - b).abs().nan_to_num(0.0).max())
                      for a, b in zip(got, want) if a.numel())
            idx = ids.long()[:, None].expand(-1, k)

            def library(x=x, idx=idx, ns=ns):
                return torch.full((ns, x.shape[1]), float("-inf"),
                                  device=dev).scatter_reduce_(0, idx, x,
                                                              "amax")

            def fn(x=x, ids=ids, ns=ns):
                return segment_reduce.segment_minmax(x, ids, ns, need="max")

            def plain(x=x, ids=ids, ns=ns):
                return segment_reduce.segment_minmax_plain(x, ids, ns,
                                                           need="max")
        # One output either way: each input byte read once, each output
        # byte written once; one add or compare per element.
        b_ms, b_by = bound_ms(n * k * 4 + n * 4 + ns * k * 4, n * k)
        res = {
            "name": name, "stage": stage, "n": n, "k": k, "segments": ns,
            "max_abs_err": err,
            "ms": median_ms(fn),
            "ms_cold": median_ms(fn, flush=flush),
            "ms_device": device_ms(fn),
            "plain_ms": median_ms(plain),
            "library_ms": median_ms(library),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        log(f"kernel {name} [{stage}] N={n} K={k} S={ns}: "
            f"{res['ms']:.4f} ms, cold {res['ms_cold']:.4f}, device "
            f"{res['ms_device']:.4f} (plain "
            f"{res['plain_ms']:.4f}, library {res['library_ms']:.4f}, "
            f"bound {b_ms:.4f} by {b_by}), max_abs_err {err:g}")
        results.append(res)
    del feat, fold, rows_t, host_max, cases, flush
    torch.cuda.empty_cache()
    return results


def padded_rows(ts: np.ndarray, vals: np.ndarray, rows: np.ndarray,
                end: int):
    """The executor's un-downsampled layout for corpus series ``rows``
    over [BASE, end]: left-aligned [S, T] int32 offsets from the earliest
    first timestamp, float32 values, [S] counts (numpy)."""
    keep = ts[rows] <= end
    counts = keep.sum(axis=1).astype(np.int32)
    T = _pad_size(int(counts.max()))
    base = int(ts[rows, 0].min())
    tp = np.zeros((len(rows), T), np.int32)
    vp = np.zeros((len(rows), T), np.float32)
    cols = np.arange(ts.shape[1])
    for i, s in enumerate(rows):
        tp[i, :counts[i]] = ts[s][cols < counts[i]] - base
        vp[i, :counts[i]] = vals[s][cols < counts[i]]
    return tp, vp, counts


def in_range_pairs(tp: np.ndarray, counts: np.ndarray,
                   grid: np.ndarray) -> int:
    """(series, grid point) pairs inside a series' [first, last]: the
    pairs this run's data makes the interpolate-and-reduce kernel
    compute."""
    first = tp[:, 0]
    last = tp[np.arange(len(tp)), counts - 1]
    return int((np.searchsorted(grid, last, side="right")
                - np.searchsorted(grid, first, side="left")).sum())


def time_case(res: dict, fn, plain, library, flush) -> dict:
    res.update({"ms": median_ms(fn), "ms_cold": median_ms(fn, flush=flush),
                "ms_device": device_ms(fn),
                "plain_ms": median_ms(plain) if plain else None,
                "library_ms": median_ms(library) if library else None})
    log(f"kernel {res['name']} [{res['stage']}]: {res['ms']:.4f} ms, cold "
        f"{res['ms_cold']:.4f}, device {res['ms_device']:.4f} (plain "
        f"{res['plain_ms']}, library {res['library_ms']}, bound "
        f"{res['bound_ms']:.4f} by {res['bound_by']}), max_abs_err "
        f"{res['max_abs_err']:g}")
    return res


def select_interp_phase(ts: np.ndarray, vals: np.ndarray) -> list:
    """The rank-select and interpolate-and-reduce kernels against their
    plain versions, at the shapes the percentile and un-downsampled
    paths give them:
    - select, columns: the window's sum:1h-avg stage (filled and in_range
      [16384, 256]) at one quantile, as a query asks, and at
      p50/p95/p99 in one call; yardstick one torch.nanquantile over the
      NaN-masked grid;
    - select, grouped: the same grid by dc (16 groups) and by host
      (16384 groups, one series each plus the padding group);
    - select, union: p95 over {dc=dc0}'s contributions on its first day's
      union grid (1000 series x ~42k points);
    - interp_moments over {dc=dc0}'s first day (held against the plain
      composition) and over all series for the week (~302k points: the
      plain composition would need ~12 GB per [S, U] array, so the sums
      are held against float64 at 256 grid points drawn with a seed)."""
    dev = torch.device(DEVICE)
    S, B = 16384, 256
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    chunk = (torch.from_numpy((ts - BASE).reshape(-1).astype(np.int32))
             .to(dev), torch.from_numpy(vals.reshape(-1)).to(dev),
             torch.from_numpy(np.repeat(np.arange(SERIES, dtype=np.int32),
                                        POINTS)).to(dev))
    _, _, filled, in_range, _ = wk.window_series_stage_chunks(
        [chunk], 0, SPAN - 1, 0, num_series=S, num_buckets=B,
        interval=INTERVAL, agg_down="avg")
    del chunk
    dc_np = np.full(S, 15, np.int32)
    dc_np[:SERIES] = np.arange(SERIES) % 10
    host_np = np.full(S, S - 1, np.int32)
    host_np[:SERIES] = np.arange(SERIES)
    results = []

    def same(got, want, what):
        torch.cuda.synchronize()
        # Both select exact rank keys and lerp with separate roundings.
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True, msg=what)
        return float((got - want).abs().nan_to_num(0.0).max())

    def select_case(stage, x, m, q, layout=None, library=True):
        rows, cols = x.shape
        if layout is None:
            def fn():
                return masked_select.select_columns(x, m, q)

            def plain():
                return masked_select.select_columns_plain(x, m, q)
            G, extra = 1, 0
        else:
            def fn():
                return masked_select.select_groups(x, m, layout, q)

            def plain():
                return masked_select.select_groups_plain(x, m, layout, q)
            G = layout.offsets.numel() - 1
            extra = 4 * (rows + G + 1 + layout.big.numel())
        lib = None
        if library:
            qt = torch.tensor(q, device=dev)
            nan_grid = torch.where(m, x, float("nan"))

            def lib():
                return torch.nanquantile(nan_grid, qt, dim=0,
                                         interpolation="linear")
        err = same(fn(), plain(), f"masked_select {stage}")
        b_ms, b_by = bound_ms(rows * cols * 5 + extra + len(q) * G * cols * 4,
                              rows * cols)
        n_big = (int(rows > masked_select.SMALL_ROWS) if layout is None
                 else layout.big.numel())
        # The large groups' cluster width and how many such clusters the
        # card co-schedules at the launch's shared memory.
        plan = masked_select.launch_plan(rows, cols, n_big, len(q)) \
            if n_big else None
        return time_case({"name": "masked_select", "stage": stage,
                          "rows": rows, "cols": cols, "groups": G,
                          "quantiles": len(q), "max_abs_err": err,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "launch_plan": plan},
                         fn, plain, lib, flush)

    results.append(select_case("window select, columns", filled, in_range,
                               [0.95]))
    results.append(select_case("window select, columns, p50/p95/p99",
                               filled, in_range, [0.5, 0.95, 0.99]))
    for stage, gmap, G in (("window select {dc=*}", dc_np, 16),
                           ("window select {host=*}", host_np, S)):
        results.append(select_case(
            stage, filled, in_range, [0.95],
            layout=masked_select.group_layout(gmap, G, dev), library=False))
    del filled, in_range

    def interp_case(stage, rows, end, plain_ok):
        tp, vp, counts = padded_rows(ts, vals, rows, end)
        t = [torch.from_numpy(a).to(dev) for a in (tp, vp, counts)]
        grid, gmask = wk.union_grid(t[0], t[2])
        grid = grid[:int(gmask.sum())]
        grid_np = grid.cpu().numpy()

        def fn():
            return interp_moments.interp_moments(*t, grid, with_m2=False)

        def plain():
            return interp_moments.interp_moments_plain(*t, grid,
                                                       with_m2=False)
        got = fn()
        torch.cuda.synchronize()
        if plain_ok:
            want = plain()
            torch.cuda.synchronize()
            for i in (0, 3, 4):   # count, min, max: the same operations
                if not torch.equal(got[i], want[i]):
                    fail(f"interp_moments {stage}: output {i} not exact")
            torch.testing.assert_close(got[1], want[1], rtol=1e-5,
                                       atol=1e-3)
            err = float((got[1] - want[1]).abs().max())
        else:
            pick = np.sort(np.random.default_rng(12).choice(
                len(grid_np), 256, replace=False))
            x = grid_np[pick]
            tot = np.zeros(256)
            cnt = np.zeros(256)
            for i in range(len(tp)):
                row = tp[i, :counts[i]]
                inside = (x >= row[0]) & (x <= row[-1])
                tot[inside] += np.interp(x[inside], row,
                                         vp[i, :counts[i]].astype(np.float64))
                cnt += inside
            if not np.array_equal(got[0].cpu().numpy()[pick], cnt):
                fail(f"interp_moments {stage}: counts differ from float64")
            # The plain composition fits at the sampled points alone.
            at = torch.from_numpy(pick).to(dev)
            want = interp_moments.interp_moments_plain(*t, grid[at],
                                                       with_m2=False)
            for i in (0, 3, 4):
                if not torch.equal(got[i][at], want[i]):
                    fail(f"interp_moments {stage}: output {i} not exact "
                         f"against the plain version")
            torch.testing.assert_close(got[1][at], want[1], rtol=1e-5,
                                       atol=1e-3)
            g_tot = got[1].cpu().numpy()[pick].astype(np.float64)
            scale = float(np.abs(tot).max())
            diff = np.abs(g_tot - tot)
            if (diff > 1e-4 * np.abs(tot) + 1e-5 * scale).any():
                fail(f"interp_moments {stage}: sums differ from float64")
            err = float(diff.max())
        S_, T_ = tp.shape
        U = len(grid_np)
        pairs = in_range_pairs(tp, counts, grid_np)
        # Per in-range pair: 2 int->float conversions, max, divide,
        # subtract, multiply, add (the lerp), then count, sum, min, max.
        b_ms, b_by = bound_ms(S_ * T_ * 8 + S_ * 4 + U * 4 + 4 * U * 4,
                              11 * pairs)
        res = {"name": "interp_moments", "stage": stage, "series": S_,
               "row_points": T_, "grid_points": U, "in_range_pairs": pairs,
               "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
               "tile": interp_moments.tile_shape(U)}
        if not plain_ok:
            res["plain_note"] = ("not measured: the plain composition "
                                 "needs an [S, U] array per step")
        return time_case(res, fn, plain if plain_ok else None, None,
                         flush), (t, grid)

    dc0 = np.arange(0, SERIES, 10)
    res, (t, grid) = interp_case("union {dc=dc0} one day", dc0,
                                 BASE + DAY - 1, True)
    results.append(res)
    contrib, cmask = wk.series_contributions(*t, grid)
    results.append(select_case("union p95 {dc=dc0} one day", contrib, cmask,
                               [0.95]))
    del contrib, cmask, t, grid
    res, _ = interp_case("union full width", np.arange(SERIES),
                         BASE + SPAN - 1, False)
    results.append(res)
    del flush
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Path phase
# ---------------------------------------------------------------------------

class Daemon:
    """The port's TSD server on loopback, on its own event-loop thread."""

    def __init__(self, tsdb: TSDB) -> None:
        self.server = TSDServer(tsdb)
        self.loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._error: BaseException | None = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        if not self._started.wait(60) or self._error is not None:
            fail(f"daemon did not start: {self._error!r}")

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self.server.start())
        except BaseException as e:  # reported by __init__
            self._error = e
            self._started.set()
            return
        self._started.set()
        self.loop.run_until_complete(self.server.serve_forever())

    @property
    def port(self) -> int:
        return self.server.port

    def stop(self) -> None:
        """Stop the server, which shuts the TSDB down (a checkpoint, the
        store closed); a second call does nothing."""
        if not self.thread.is_alive():
            return
        self.loop.call_soon_threadsafe(self.server.request_shutdown)
        self.thread.join(600)
        if self.thread.is_alive():
            fail("daemon did not stop")


def telnet(port: int, lines: list[str], pause: bool = False) -> str:
    """Send ``lines``, then ``version`` and ``exit``; everything the
    daemon answered. ``pause`` waits before the last two, so a last
    ``put`` line takes the per-line path, not the bulk path."""
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(("\n".join(lines) + "\n").encode())
        if pause:
            time.sleep(0.3)
        s.sendall(b"version\nexit\n")
        chunks = []
        while True:
            data = s.recv(65536)
            if not data:
                break
            chunks.append(data)
    return b"".join(chunks).decode()


def http_get(port: int, target: str) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", target)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_post(port: int, target: str, body: bytes) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", target, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_json(port: int, target: str):
    status, body = http_get(port, target)
    if status != 200:
        fail(f"{target}: HTTP {status}: {body[:300]!r}")
    return json.loads(body)


def spec_of(expr: str) -> QuerySpec:
    p = parse_m(expr)
    return QuerySpec(p.metric, p.tags, p.aggregator, p.rate, p.downsample,
                     p.counter, p.counter_max, p.reset_value)


def check_answer(expr: str, got: list, want, rtol: float,
                 against: str) -> float:
    """The JSON answer against ``want``'s results: same groups, tags and
    timestamps; values within ``rtol`` plus 1e-5 of the answer's largest
    magnitude (float32 sums over 10k series, in a run-dependent order;
    rate sums cancel across series, so a pure relative bound would be
    meaningless near zero). Returns the largest relative-to-scale
    error."""
    if len(got) != len(want):
        fail(f"{expr}: {len(got)} groups, {against} {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        if g["tags"] != w.tags:
            fail(f"{expr}: tags {g['tags']} vs {against} {w.tags}")
        ts = np.array([int(t) for t in g["dps"]], np.int64)
        vals = np.array(list(g["dps"].values()), np.float64)
        if not np.array_equal(ts, w.timestamps):
            fail(f"{expr}: timestamps differ from the {against}'s")
        if not np.isfinite(vals).all() or len(vals) == 0:
            fail(f"{expr}: empty or non-finite answer")
        scale = float(np.abs(w.values).max())
        tol = rtol * np.abs(w.values) + 1e-5 * scale
        err = np.abs(vals - w.values)
        if (err > tol).any():
            i = int(np.argmax(err - tol))
            fail(f"{expr}: value {vals[i]!r} vs {against} "
                 f"{w.values[i]!r} at {ts[i]}")
        worst = max(worst, float((err / max(scale, 1e-30)).max()))
    return worst


KERNELS = ("segment_sum", "segment_minmax", "masked_select",
           "interp_moments")


def launches() -> tuple[int, int, int, int]:
    """Kernel launches per kernel; masked_select counts both of its
    entry points."""
    return (segment_reduce.segment_sum.launches,
            segment_reduce.segment_minmax.launches,
            masked_select.select_columns.launches
            + masked_select.select_groups.launches,
            interp_moments.interp_moments.launches)


def zero_launches() -> None:
    segment_reduce.segment_sum.launches = 0
    segment_reduce.segment_minmax.launches = 0
    masked_select.select_columns.launches = 0
    masked_select.select_groups.launches = 0
    interp_moments.interp_moments.launches = 0


def path_launches(path: str, kernels: tuple) -> dict:
    """The counts since zero_launches(), read just after ``path`` ran;
    a kernel of ``kernels`` the path never launched fails the run."""
    out = dict(zip(KERNELS, launches()))
    for name in kernels:
        if out[name] == 0:
            fail(f"the {path} never launched {name}")
    return out


def telnet_corpus_lines() -> tuple[list, list]:
    """The corpus' telnet part: TELNET_SERIES series of TELNET_POINTS
    points, from a seed; the put lines and each point's (host, dc,
    value)."""
    rng = np.random.default_rng(2)
    lines = []
    telnet_vals = []
    for s in range(TELNET_SERIES):
        tt = np.sort(rng.choice(SPAN, TELNET_POINTS, replace=False))
        for t, v in zip(tt + BASE, rng.normal(100, 1, TELNET_POINTS)):
            lines.append(f"put bench.metric {t} {v:.4f} host=t{s:02d} "
                         f"dc=dc{s % 10}")
            telnet_vals.append((f"t{s:02d}", f"dc{s % 10}",
                                float(f"{v:.4f}")))
    return lines, telnet_vals


def ingest(tsdb: TSDB, port: int, ts: np.ndarray, vals: np.ndarray,
           stage: str = "", barrier_series: int = 0) -> dict:
    """The corpus through add_batch, then telnet puts; the window mirrors
    every write and the live sketches buffer every value (folding on
    their own thread at each hand-off). After the rate's clock stops, the
    sketches' remaining buffer is folded and timed apart. ``stage``
    prefixes the native stages' names; ``barrier_series`` > 0 writes the
    corpus as wire batches of that many series do under group commit
    (``sync=False`` per series, one covering ``wal_barrier()`` per
    batch)."""
    with native_calls(stage + "corpus_ingest",
                      ("slice_cells", "slice_keys", "upsert_cells")):
        t0 = time.perf_counter()
        for s in range(SERIES):
            tsdb.add_batch("bench.metric", ts[s], vals[s], series_tags(s),
                           sync=not barrier_series)
            if barrier_series and (s + 1) % barrier_series == 0:
                tsdb.store.wal_barrier()
        tsdb.store.wal_barrier()
        t_batch = time.perf_counter() - t0
    lines, telnet_vals = telnet_corpus_lines()
    with native_calls(stage + "telnet_ingest",
                      ("tsd_parse", "slice_cells", "slice_keys",
                       "upsert_cells")):
        t1 = time.perf_counter()
        said = telnet(port, lines)
        t_telnet = time.perf_counter() - t1
    if "put:" in said or "opentsdb_tpu_torch" not in said:
        fail(f"telnet ingest answered: {said[:500]!r}")
    points = SERIES * POINTS + len(lines)
    t2 = time.perf_counter()
    sk = tsdb.sketches
    sk.flush()
    out = {"points": points, "batch_s": t_batch, "telnet_s": t_telnet,
           "telnet_lines": len(lines),
           "points_per_s": points / (t_batch + t_telnet),
           "add_batch_points_per_s": SERIES * POINTS / t_batch,
           "telnet_points_per_s": len(lines) / t_telnet,
           "without_sketches_points_per_s":
               INGEST_WITHOUT_SKETCHES_POINTS_PER_S,
           "window_appended": tsdb.devwindow.appended_points,
           "sketch_drain_s": time.perf_counter() - t2,
           "sketch_hand_offs": sk.hand_offs,
           "sketch_fold_calls": sk.fold_calls,
           "sketch_state_bytes": sk.state_bytes(),
           "sketch_series": sk.series_count()}
    if out["window_appended"] != points:
        fail(f"the window mirrored {out['window_appended']} of {points} "
             f"points")
    if out["sketch_series"] != SERIES + TELNET_SERIES:
        fail(f"the sketches hold {out['sketch_series']} series")
    log(f"ingest: {points} points in {t_batch + t_telnet:.1f} s "
        f"({out['points_per_s']:,.0f} points/s, window mirroring on, "
        f"sketches folding; earlier run without sketches: "
        f"{INGEST_WITHOUT_SKETCHES_POINTS_PER_S:,.0f}); sketch drain "
        f"{out['sketch_drain_s']:.2f} s, {sk.hand_offs} hand-offs, "
        f"{sk.fold_calls} fold calls, {out['sketch_state_bytes']} bytes "
        f"of sketch state")
    return out, telnet_vals


def http_resident(port: int, dw: DeviceWindow, ex: QueryExecutor,
                  expr: str, start: int, end: int) -> tuple[dict, list]:
    """One /q run that must be served from the window: every group says
    "rollup": "resident" and the window's hit count rises by one."""
    target = "/q?" + urllib.parse.urlencode(
        {"start": start, "end": end, "m": expr, "json": ""})
    before, hits = launches(), dw.window_hits
    keys = set(ex._dw_stage_cache.keys())
    q0 = time.perf_counter()
    status, body = http_get(port, target)
    wall = (time.perf_counter() - q0) * 1e3
    if status != 200:
        fail(f"{expr}: HTTP {status}: {body[:300]!r}")
    answer = json.loads(body)
    if not answer or any(g["rollup"] != "resident" for g in answer):
        fail(f"{expr}: not served from the resident window: "
             f"{[g.get('rollup') for g in answer]}")
    if dw.window_hits != hits + 1:
        fail(f"{expr}: window hits {hits} -> {dw.window_hits}, not +1")
    after = launches()
    return {"wall_ms": wall,
            "stage_built": bool(set(ex._dw_stage_cache.keys()) - keys),
            **{k: a - b for k, a, b in zip(KERNELS, after, before)}}, answer


def http_union(port: int, expr: str, start: int,
               end: int) -> tuple[list, dict, bytes]:
    """One /q run of a query without a downsampler: every group says
    "rollup": "raw"; a moment query must launch interp_moments and a
    percentile one masked_select. Returns the answer, the run's record
    (whether every group said "cached": true among it) and the body."""
    target = "/q?" + urllib.parse.urlencode(
        {"start": start, "end": end, "m": expr, "json": ""})
    before = launches()
    q0 = time.perf_counter()
    status, body = http_get(port, target)
    wall = (time.perf_counter() - q0) * 1e3
    if status != 200:
        fail(f"{expr}: HTTP {status}: {body[:300]!r}")
    answer = json.loads(body)
    if not answer or any(g["rollup"] != "raw" for g in answer):
        fail(f"{expr}: not answered by the scan path: "
             f"{[g.get('rollup') for g in answer]}")
    got = {k: a - b for k, a, b in zip(KERNELS, launches(), before)}
    need = ("masked_select" if Aggregators.get(spec_of(expr).aggregator)
            .kind == "percentile" else "interp_moments")
    if got[need] == 0:
        fail(f"{expr}: launched no {need}")
    run = {"wall_ms": wall, "launches": got, "groups": len(answer),
           "points": sum(len(g["dps"]) for g in answer),
           "cached": all(g["cached"] for g in answer)}
    log(f"union query {expr}: {wall:.1f} ms, {run['points']} points, "
        f"cached {run['cached']}, launches {got}")
    return answer, run, body


def qcache_counters(ex: QueryExecutor, store: MemKVStore) -> dict:
    """The executor's fragment-cache counters, the store's bloom skips,
    and what the shared fragment cache holds: entries, points (its cost)
    and the bytes of their columns in host RAM."""
    cache = ex._frag_cache
    nbytes = 0
    for key in cache.keys():
        ent = cache.peek(key)
        if ent is not None:
            nbytes += sum(c.timestamps.nbytes + c.values.nbytes
                          + c.int_values.nbytes + c.is_float.nbytes
                          for c in ent[1].values())
    return {"hits": ex.qcache_hits, "misses": ex.qcache_misses,
            "bypasses": ex.qcache_bypasses,
            "bloom_files_skipped": store.bloom_files_skipped,
            "fragments": len(cache), "fragment_points": cache.cost,
            "fragment_bytes": nbytes}


def repeat_union(port: int, expr: str, start: int, end: int,
                 first: tuple | None = None) -> dict:
    """A second /q run of an un-downsampled query on a daemon whose
    memtable holds none of the range: it must come from the fragment
    cache ("cached": true) with the first run's bytes but for that flag,
    and launch its kernel again (http_union checks that). ``first``: an
    earlier http_union result of the same request, else one is made."""
    _, r1, b1 = first or http_union(port, expr, start, end)
    _, r2, b2 = http_union(port, expr, start, end)
    if not r2["cached"]:
        fail(f"{expr}: the repeat was not served from the fragment cache")
    if b1.replace(b'"cached": false', b'"cached": true') != b2:
        fail(f"{expr}: the cached repeat's body differs from the first's")
    return {"first_ms": r1["wall_ms"], "repeat_ms": r2["wall_ms"],
            "first_cached": r1["cached"], "repeat_cached": r2["cached"],
            "same_bytes": True,
            "launches": [r1["launches"], r2["launches"]]}


def regroup(ex: QueryExecutor, spans: list, tags: dict) -> dict:
    """Spans of one scan grouped as a scan with ``tags`` would group
    them (the executor's own series selector on UIDs)."""
    selector = ex._series_selector(*ex._tag_filters(tags))
    groups: dict = {}
    for sp in spans:
        g = selector(sp.series_key)
        if g is not None:
            groups.setdefault(g, []).append(sp)
    return groups


def trim(spans: list, start: int, end: int) -> list:
    out = []
    for sp in spans:
        m = (sp.timestamps >= start) & (sp.timestamps <= end)
        if m.any():
            out.append(_Span(sp.series_key, sp.tags, sp.timestamps[m],
                             sp.values[m]))
    return out


def oracle_percentiles(ex: QueryExecutor, spec: QuerySpec, groups: dict,
                       downsampled: dict) -> list:
    """The float64 oracle's answer to a downsampled percentile query from
    per-series oracle downsamples computed once (``downsampled``: series
    key -> (bucket starts, values)): oracle.group_aggregate per group; a
    group of one series answers its own buckets, which is what the
    quantile of one value is."""
    out = []
    for gkey in sorted(groups):
        spans = groups[gkey]
        series = [downsampled[sp.series_key] for sp in spans]
        if len(series) == 1:
            ts, vals = series[0]
        else:
            ts, vals = oracle.group_aggregate(series, spec.aggregator)
        tags, aggregated = ex._group_tags(spans)
        out.append(QueryResult(spec.metric, tags, aggregated, ts, vals))
    return out


def sampled_sum_check(answer: list, spans: list, seed: int = 11) -> dict:
    """The full-width un-downsampled sum against float64 at 256 of its
    grid points drawn with a seed: per series np.interp inside its
    [first, last], summed. The grid itself must be the union of the
    spans' timestamps."""
    (g,) = answer
    ts = np.array([int(t) for t in g["dps"]], np.int64)
    vals = np.array(list(g["dps"].values()), np.float64)
    union = np.unique(np.concatenate([sp.timestamps for sp in spans]))
    if not np.array_equal(ts, union):
        fail("sum:bench.metric: the grid is not the union of the series")
    pick = np.sort(np.random.default_rng(seed).choice(len(ts), 256,
                                                      replace=False))
    x = ts[pick]
    want = np.zeros(len(x))
    for sp in spans:
        inside = (x >= sp.timestamps[0]) & (x <= sp.timestamps[-1])
        want[inside] += np.interp(x[inside], sp.timestamps, sp.values)
    scale = float(np.abs(want).max())
    err = np.abs(vals[pick] - want)
    if (err > 1e-4 * np.abs(want) + 1e-5 * scale).any():
        i = int(np.argmax(err))
        fail(f"sum:bench.metric: {vals[pick][i]!r} vs float64 {want[i]!r} "
             f"at {x[i]}")
    return {"points": len(ts), "sampled": len(x),
            "rel_err": float(err.max() / scale)}


def new_answer_checks(ex: QueryExecutor, tsdb: TSDB, spans: list,
                      answers: dict, union_answers: dict, start: int,
                      end: int) -> dict:
    """Given the spans of one host scan of every series over the week:
    the resident percentile answers against the scan path's kernels on
    them and against the oracle; the union answers against the oracle on
    the spans trimmed to their range (the full-width sum: sampled)."""
    out: dict = {}
    s0 = time.perf_counter()
    downsampled = {sp.series_key: oracle.downsample(
        sp.timestamps, sp.values, INTERVAL, "avg", mode="aligned",
        bucket_ts="start") for sp in spans}
    out["oracle_downsample_ms"] = (time.perf_counter() - s0) * 1e3
    for expr in PCT_QUERIES:
        spec = spec_of(expr)
        g = regroup(ex, spans, spec.tags)
        scan = ex._execute_groups(spec, g, start, end)
        want = REFERENCE["oracle"][expr] = oracle_percentiles(
            ex, spec, g, downsampled)
        out[expr] = {
            "scan_rel_err": check_answer(expr, answers[expr], scan, 1e-5,
                                         "scan path"),
            "oracle_rel_err": check_answer(expr, answers[expr], want,
                                           1e-4, "oracle")}
        log(f"check {expr}: {out[expr]}")
    cpu = QueryExecutor(tsdb, backend="cpu")
    for expr, span in UNION_QUERIES:
        if expr == "sum:bench.metric":
            out[expr] = sampled_sum_check(union_answers[expr], spans)
        else:
            spec = spec_of(expr)
            q_end = start + span - 1
            g = regroup(ex, trim(spans, start, q_end), spec.tags)
            out[expr] = {"oracle_rel_err": check_answer(
                expr, union_answers[expr],
                cpu._execute_groups(spec, g, start, q_end), 1e-4,
                "oracle")}
        log(f"check {expr}: {out[expr]}")
    return out


def sync_ms(fn) -> tuple[float, object]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def stage_and_apply(ex: QueryExecutor, dw: DeviceWindow, spec: QuerySpec,
                    start: int, end: int) -> dict:
    """In process, synchronised, median of 3 after a warm-up: the chunk
    stage (window_series_stage_chunks) and the apply plus the fetch of
    its clipped grids, as _run_devwindow calls them, on the executor's
    cached include/gmap."""
    muid = ex.tsdb.metrics.get_id(spec.metric)
    cols = dw.chunk_columns(muid, start, end)
    interval, dsagg = spec.downsample
    qbase = start - start % interval
    num_buckets = _pad_size(int((end - qbase) // interval + 1))

    def stage():
        return wk.window_series_stage_chunks(
            cols.chunks, start - cols.epoch, end - cols.epoch,
            qbase - cols.epoch,
            num_series=_pad_size(len(cols.series_keys)),
            num_buckets=num_buckets, interval=interval, agg_down=dsagg,
            **ex._rate_kw(spec))

    grids = stage()  # warm-up: the allocator's first blocks
    stage_runs = [sync_ms(stage)[0] for _ in range(3)]
    exact, group_bys = ex._tag_filters(spec.tags)
    _, include, gmap, layout = ex._dw_mask_cache.get(
        (dw.instance_id, muid, _filter_key(exact, group_bys)))
    groups, _ = ex._devwindow_groups(dw, muid, cols, exact, group_bys)
    ngroups = 1 if len(groups) == 1 else _pad_size(len(groups))
    shrink = dict(g_out=min(ngroups, _pad64(len(groups))),
                  b_out=min(num_buckets,
                            _pad64(int((end - qbase) // interval + 1))))
    agg = Aggregators.get(spec.aggregator)

    def apply():
        if agg.kind == "percentile":
            gv, gm = wk.window_quantile_apply(
                grids[1], grids[2], grids[3], include, gmap,
                [agg.quantile], num_groups=ngroups, layout=layout, **shrink)
        else:
            gv, gm = wk.window_moment_apply(
                *grids[:4], include, gmap, num_groups=ngroups,
                agg_group=spec.aggregator, **shrink)
        return gv.cpu().numpy(), gm.cpu().numpy()

    apply()  # warm-up
    apply_runs = [sync_ms(apply)[0] for _ in range(3)]
    return {"chunks": len(cols.chunks),
            "stage_ms": statistics.median(stage_runs),
            "stage_ms_runs": stage_runs,
            "apply_fetch_ms": statistics.median(apply_runs)}


def profile_share(ex: QueryExecutor, spec: QuerySpec, start: int,
                  end: int, plan: str = "resident", match: tuple = ()) -> dict:
    """One query in process under torch.profiler, which must take
    ``plan``: device-busy share = the summed durations of the card's
    activities (kernels, copies, fills) over the query's wall time. "not
    measured" when the trace holds no device activity. With ``match``,
    also the device ms of the activities whose names hold one of those
    strings, and their share of the device-busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms, (_, got, _) = sync_ms(
            lambda: ex.run_with_plan(spec, start, end))
    if got != plan:
        fail(f"profiled query took plan {got!r}, not {plan!r}")
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_events": len(dev),
           "device_busy_ms": busy_ms if dev else "not measured",
           "device_busy_share": busy_ms / wall_ms if dev
           else "not measured",
           "top_device_ms": top}
    if match:
        got = sum(ms for name, ms in by_name.items()
                  if any(m in name for m in match))
        out["matched"] = list(match)
        out["matched_ms"] = got if dev else "not measured"
        out["matched_share_of_busy"] = (got / busy_ms if dev and busy_ms
                                        else "not measured")
    return out


def open_daemon_tsdb(wal: str, shards: int = 0,
                     wal_group_ms: float = 0.0) -> TSDB:
    """The TSDB as ``tsdb tsd`` opens it (tools/cli.py cmd_tsd): the
    default Config (the window, the sketches and tenant accounting on;
    ``--shards`` and ``--wal-group-ms`` as given), then the heap frozen
    out of cycle collection."""
    tsdb = open_tsdb(Config(auto_create_metrics=True, port=0,
                            bind="127.0.0.1", device=DEVICE,
                            wal_group_ms=wal_group_ms), wal, shards=shards)
    tune_for_ingest()
    if tsdb.devwindow is None or tsdb.tenants is None:
        fail("the daemon's TSDB came up without the resident window or "
             "tenant accounting")
    return tsdb


class GcClock:
    """Collections and their pause per generation while installed as a
    ``gc.callbacks`` entry."""

    def __init__(self) -> None:
        self.count, self.ms, self._t = [0, 0, 0], [0.0, 0.0, 0.0], 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.count[g] += 1
            self.ms[g] += (time.perf_counter() - self._t) * 1e3


# ---------------------------------------------------------------------------
# Observability
# ---------------------------------------------------------------------------

OBS_SCAN_QUERY = UNION_QUERIES[1]      # zimsum {dc=dc0} over one day
OBS_REPS = 10                          # untraced / traced warm pairs
OBS_ROUTES = ("/stats", "/stats?json", "/metrics", "/logs",
              "/api/traces", "/api/queries")


def validate_exposition(text: str) -> int:
    """Prometheus text exposition, checked the way scrapers fail on it:
    each sample under a ``# TYPE`` line of its family that precedes it,
    families contiguous, no (name, labels) twice, every value a float.
    Returns the sample count."""
    declared: dict = {}
    seen = set()
    current = None
    n = 0
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("# TYPE "):
            _, _, name, ftype = line.split(" ")
            if name in declared or ftype not in (
                    "counter", "gauge", "summary", "histogram", "untyped"):
                fail(f"/metrics: bad or repeated TYPE line {line!r}")
            declared[name] = ftype
            current = name
            continue
        name, _, rest = line.partition("{")
        if rest:
            labels, _, value = rest.partition("} ")
        else:
            name, _, value = line.partition(" ")
            labels = ""
        ok = {current} | ({current + "_count", current + "_sum"}
                          if declared.get(current) == "summary" else set())
        float(value)
        if current is None or name not in ok or (name, labels) in seen:
            fail(f"/metrics: sample {line!r} outside its family")
        seen.add((name, labels))
        n += 1
    return n


def stat_lines(port: int) -> dict:
    """name -> {tags (host aside) -> value} of the daemon's /stats."""
    status, body = http_get(port, "/stats")
    if status != 200:
        fail(f"/stats: HTTP {status}")
    out: dict = {}
    for ln in body.decode().splitlines():
        parts = ln.split()
        tags = " ".join(t for t in parts[3:] if not t.startswith("host="))
        out.setdefault(parts[0], {})[tags] = float(parts[2])
    return out


def timer_lines(stats: dict, name: str) -> dict:
    """A timer's /stats lines by tag set: p50/p95/p99, count, sum_ms."""
    out: dict = {}
    for tags, v in stats.get(f"tsd.{name}", {}).items():
        base = " ".join(t for t in tags.split()
                        if not t.startswith("percentile="))
        pct = tags.split("percentile=")[-1] if "percentile=" in tags else ""
        out.setdefault(base, {})[f"p{pct}"] = v
    for suffix in ("count", "sum_ms"):
        for tags, v in stats.get(f"tsd.{name}.{suffix}", {}).items():
            out.setdefault(tags, {})[suffix] = v
    return out


def timer_totals(name: str) -> dict:
    """count and sum_ms per tag set of one registry timer, read in
    process (for the deltas across a stretch of the smoke)."""
    return {" ".join(f"{k}={v}" for k, v in tkey): (obj.count,
                                                     obj.total_ms)
            for n, kind, tkey, obj in METRICS._snapshot() if n == name}


def timer_delta(before: dict, after: dict) -> dict:
    return {tags: {"count": c - before.get(tags, (0, 0.0))[0],
                   "sum_ms": s - before.get(tags, (0, 0.0))[1]}
            for tags, (c, s) in sorted(after.items())}


def span_names(tree: dict) -> list:
    return [tree["name"]] + [n for c in tree.get("spans", ())
                             for n in span_names(c)]


def check_children_fit(tree: dict, what: str) -> None:
    """Each span's children take at most its own wall time (the
    rounding of three decimals aside)."""
    kids = tree.get("spans", ())
    total = sum(k["ms"] for k in kids)
    if total > tree["ms"] + 1e-3 * (len(kids) + 1):
        fail(f"{what}: the children of {tree['name']} sum to {total} ms "
             f"over its {tree['ms']} ms")
    for k in kids:
        check_children_fit(k, what)


def check_scan_tree(tree: dict, expr: str, shards: int) -> None:
    """The JAX daemon's tree for a raw (scan) plan: planner.pick, scan
    (cached, qcache_* tags) over chunk.decode spans (one shard.scan per
    shard under each over a sharded store), aggregate."""
    top = [c["name"] for c in tree.get("spans", ())]
    if top != ["planner.pick", "scan", "aggregate"] \
            or tree["tags"] != {"q": expr, "plan": "raw", "cached": False}:
        fail(f"{expr}: scan trace shape {top} {tree['tags']}")
    pick, scan, _ = tree["spans"]
    if pick.get("tags") != {"plan": "raw"} or "spans" in pick:
        fail(f"{expr}: planner.pick {pick}")
    # All chunks in the memtable: one unchunked scan, counted as bypasses
    # alone; otherwise the hit, miss and bypass counts.
    qtags = set(scan["tags"]) - {"cached"}
    if scan["tags"].get("cached") is not False or not qtags or not qtags \
            <= {"qcache_hit", "qcache_miss", "qcache_bypass"}:
        fail(f"{expr}: scan tags {scan['tags']}")
    decodes = scan.get("spans", ())
    if not decodes or any(
            d["name"] != "chunk.decode"
            or d["tags"]["outcome"] not in ("unchunked", "bypass", "miss")
            for d in decodes):
        fail(f"{expr}: scan children {[d['name'] for d in decodes]}")
    for d in decodes:
        kids = d.get("spans", ())
        got = sorted(k["tags"]["shard"] for k in kids)
        if shards > 1 and (len(set(got)) != len(got)
                           or not set(got) <= set(range(shards))
                           or len(got) + d["tags"].get("shards_skipped", 0)
                           != shards):
            fail(f"{expr}: chunk.decode without a shard.scan per shard "
                 f"not skipped: {got}, {d['tags']}")
        if shards == 1 and kids:
            fail(f"{expr}: shard spans over a one-shard store")


def traced_q(port: int, expr: str, start: int, end: int,
             trace: bool) -> tuple[float, list]:
    params = {"start": start, "end": end, "m": expr, "json": ""}
    if trace:
        params["trace"] = "1"
    q0 = time.perf_counter()
    status, body = http_get(port, "/q?" + urllib.parse.urlencode(params))
    wall = (time.perf_counter() - q0) * 1e3
    if status != 200:
        fail(f"{expr}: HTTP {status}: {body[:300]!r}")
    answer = json.loads(body)
    if not answer or any(("trace" in g) != trace for g in answer):
        fail(f"{expr}: trace key {'missing' if trace else 'present'}")
    return wall, answer


def profiled_q(port: int, expr: str, start: int, end: int) -> dict:
    """One traced /q under torch.profiler: each top-level span's ms
    beside the card's busy ms over the request (the daemon shares this
    process, so its launches are traced)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, answer = traced_q(port, expr, start, end, True)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    tree = answer[0]["trace"]
    return {"wall_ms": wall, "trace_ms": tree["ms"],
            "spans_ms": {c["name"]: c["ms"] for c in tree.get("spans", ())},
            "device_busy_ms": busy if dev else "not measured",
            "device_events": len(dev)}


def obs_phase(daemon: "Daemon", start: int, end: int) -> dict:
    """On the path phase's daemon: traced resident and scan /q (the span
    trees' shapes, children within their parents, each beside the card's
    busy ms), untraced against traced warm wall ms, and every
    observability route and the telnet stats command answering."""
    port = daemon.port
    out: dict = {}
    expr = QUERIES[1]
    untraced, traced = [], []
    for _ in range(OBS_REPS):
        untraced.append(traced_q(port, expr, start, end, False)[0])
        wall, answer = traced_q(port, expr, start, end, True)
        traced.append(wall)
    for g in answer:
        tree = g["trace"]
        want = {"name": "query", "tags": {"q": expr, "plan": "resident",
                                          "cached": False}}
        if {k: tree[k] for k in ("name", "tags")} != want \
                or [c["name"] for c in tree["spans"]] != ["planner.pick"] \
                or tree["spans"][0].get("tags") != {"plan": "resident"}:
            fail(f"{expr}: resident trace shape {tree}")
        check_children_fit(tree, expr)
    out["resident"] = {
        "query": expr, "untraced_warm_ms": untraced,
        "traced_warm_ms": traced,
        "untraced_warm_p50_ms": statistics.median(untraced),
        "traced_warm_p50_ms": statistics.median(traced),
        "trace": answer[0]["trace"],
        "profiled": profiled_q(port, expr, start, end)}
    sexpr, span = OBS_SCAN_QUERY
    wall, answer = traced_q(port, sexpr, start, start + span - 1, True)
    for g in answer:
        check_scan_tree(g["trace"], sexpr, 1)
        check_children_fit(g["trace"], sexpr)
    out["scan"] = {"query": sexpr, "wall_ms": wall,
                   "trace": answer[0]["trace"],
                   "profiled": profiled_q(port, sexpr, start,
                                          start + span - 1)}
    for k in ("resident", "scan"):
        log(f"obs {k} {out[k]['query']}: {out[k]['profiled']}")
    log(f"obs: untraced warm {untraced} ms, traced {traced} ms")
    answered = {}
    for route in OBS_ROUTES:
        status, body = http_get(port, route)
        # The log ring holds what the root logger let through (WARNING
        # and up by default): it may be empty.
        if status != 200 or not (body.strip() or route == "/logs"):
            fail(f"{route}: HTTP {status}, {len(body)} bytes")
        answered[route] = len(body)
    if not isinstance(http_json(port, "/logs?json"), list):
        fail("/logs?json is not a list")
    out["metrics_samples"] = validate_exposition(
        http_get(port, "/metrics")[1].decode())
    records = http_json(port, "/api/traces")
    if len(records) < OBS_REPS + 2 or any(
            r["trace"]["name"] != "query" for r in records):
        fail(f"/api/traces holds {len(records)} records")
    said = telnet(port, ["stats"])
    stats = [ln for ln in said.splitlines() if ln.startswith("tsd.")]
    if len(stats) < 100:
        fail(f"telnet stats answered {len(stats)} lines")
    answered["telnet stats"] = len(stats)
    out["answered"] = answered
    return out


def path_phase(ts: np.ndarray, vals: np.ndarray, wal_dir: str) -> dict:
    tsdb = open_daemon_tsdb(os.path.join(wal_dir, "wal"))
    dw = tsdb.devwindow
    daemon = Daemon(tsdb)
    ex = daemon.server.executor
    out: dict = {"queries": {}, "launches": {}}
    try:
        zero_sketch_launches()
        clock = GcClock()
        gc.callbacks.append(clock)
        try:
            out["ingest"], telnet_vals = ingest(tsdb, daemon.port, ts, vals)
        finally:
            gc.callbacks.remove(clock)
        out["ingest"]["gc"] = {"collections": clock.count,
                               "pause_ms": clock.ms}
        log(f"gc during ingest (heap frozen at open): collections per "
            f"generation {clock.count}, pause ms {clock.ms}")
        start, end = BASE, BASE + SPAN - 1
        # The sketch routes, right after ingest: the folds' launches
        # (ingest and the first query's flush) and the queries' count for
        # this path.
        out["sketch"] = sketch_path(tsdb, daemon.port, vals, telnet_vals,
                                    start, end)
        out["launches"]["sketch"] = sketch_launches()
        for name, n in out["launches"]["sketch"].items():
            if n == 0:
                fail(f"the sketch path never launched {name}")
        out["tenants"] = http_put_phase(daemon.port, start, end)
        answers = {}
        zero_launches()
        for expr in QUERIES + PCT_QUERIES:
            runs = []
            for _ in range(1 + WARM_REPS):
                run, answers[expr] = http_resident(daemon.port, dw, ex,
                                                   expr, start, end)
                runs.append(run)
            first, warm = runs[0], runs[1:]
            if first["stage_built"] and first["segment_sum"] == 0:
                fail(f"{expr}: its stage build launched no segment_sum")
            if expr in PCT_QUERIES and any(r["masked_select"] == 0
                                           for r in runs):
                fail(f"{expr}: a run launched no masked_select")
            out["queries"][expr] = {
                "first_ms": first["wall_ms"],
                "first_built_stage": first["stage_built"],
                "first_launches": {k: first[k] for k in KERNELS},
                "warm_p50_ms": statistics.median(
                    r["wall_ms"] for r in warm),
                "warm_ms": [r["wall_ms"] for r in warm],
                "warm_launches_per_query": {
                    k: sum(r[k] for r in warm) / len(warm)
                    for k in KERNELS}}
            q = out["queries"][expr]
            log(f"query {expr}: first {q['first_ms']:.1f} ms (stage "
                f"built: {q['first_built_stage']}), warm p50 "
                f"{q['warm_p50_ms']:.1f} ms (runs "
                f"{', '.join(f'{w:.1f}' for w in q['warm_ms'])})")
        out["launches"]["resident"] = path_launches("resident path",
                                                    KERNELS[:3])
        out["window"] = {"resident_points": dw._total_points,
                         "hits": dw.window_hits,
                         "misses": dw.window_misses,
                         "dirty_fallbacks": dw.dirty_fallbacks}

        # Queries without a downsampler over HTTP: the window declines
        # them, the scan path answers on the union grid.
        union_answers = {}
        out["union"] = {}
        zero_launches()
        for expr, span in UNION_QUERIES:
            union_answers[expr], out["union"][expr], _ = http_union(
                daemon.port, expr, start, start + span - 1)
        out["launches"]["union"] = path_launches(
            "union path", ("masked_select", "interp_moments"))
        REFERENCE.update(resident=dict(answers), union=dict(union_answers),
                         oracle={})
        # Before any checkpoint every chunk of the week holds memtable
        # rows: the fragment cache is bypassed, nothing is cached, and the
        # answers are the whole-range scan's.
        out["qcache"] = qcache_counters(ex, tsdb.store)
        if out["qcache"]["hits"] or out["qcache"]["misses"] \
                or not out["qcache"]["bypasses"] \
                or any(r["cached"] for r in out["union"].values()):
            fail(f"the fragment cache served the live memtable: "
                 f"{out['qcache']}")
        log(f"fragment cache before any checkpoint: {out['qcache']}")

        # In process: where a resident query's time goes.
        for expr in QUERIES + PCT_QUERIES:
            out["queries"][expr].update(
                stage_and_apply(ex, dw, spec_of(expr), start, end))

        # The same queries on the scan path of the same TSDB: one host
        # scan of every series over the week (timed), its spans regrouped
        # per query as a scan with that filter groups them, then each
        # query's device stage (timed, launches counted).
        s0 = time.perf_counter()
        week = ex._find_spans(spec_of("sum:bench.metric{host=*}"), start,
                              end)
        spans = [sp for g in sorted(week) for sp in week[g]]
        out["scan_ms"] = (time.perf_counter() - s0) * 1e3
        log(f"host scan of every series over the week: "
            f"{out['scan_ms']:.0f} ms, {len(spans)} spans")
        scans = {}
        tsdb.devwindow = None
        try:
            zero_launches()
            for expr in QUERIES:
                spec = spec_of(expr)
                q = out["queries"][expr]
                before = launches()
                groups = regroup(ex, spans, spec.tags)
                s1 = time.perf_counter()
                scans[expr] = (groups, ex._execute_groups(spec, groups,
                                                          start, end))
                torch.cuda.synchronize()
                q["execute_ms"] = (time.perf_counter() - s1) * 1e3
                q["scan_launches"] = {
                    k: a - b for k, a, b in zip(KERNELS, launches(),
                                                before)}
                if q["scan_launches"]["segment_sum"] == 0:
                    fail(f"{expr}: the scan path launched no segment_sum")
            out["launches"]["scan"] = path_launches("scan path",
                                                    KERNELS[:2])
        finally:
            tsdb.devwindow = dw

        # Each resident answer against the scan path's, and both against
        # the float64 oracle on the scanned spans.
        oracle = QueryExecutor(tsdb, backend="cpu")
        for expr in QUERIES:
            spec = spec_of(expr)
            q = out["queries"][expr]
            groups, scan = scans.pop(expr)
            q["scan_rel_err"] = check_answer(expr, answers[expr], scan,
                                             1e-5, "scan path")
            want = REFERENCE["oracle"][expr] = oracle._execute_groups(
                spec, groups, start, end)
            q["oracle_rel_err"] = check_answer(expr, answers[expr], want,
                                               1e-4, "oracle")
            log(f"query {expr}: {q['chunks']} chunks, stage "
                f"{q['stage_ms']:.2f} ms, apply+fetch "
                f"{q['apply_fetch_ms']:.2f} ms; scan path: device stage "
                f"{q['execute_ms']:.0f} ms, launches "
                f"{q['scan_launches']}")

        # The percentile and union answers against the same spans: the
        # resident percentiles against the scan path's device kernels on
        # them, and every new answer against the float64 oracle.
        out["checks"] = new_answer_checks(ex, tsdb, spans, answers,
                                          union_answers, start, end)

        # torch.profiler over one warm resident query, and over one whose
        # stage is rebuilt (its cache entry dropped first).
        spec = spec_of(QUERIES[1])
        out["profile_warm"] = profile_share(ex, spec, start, end)
        for k in ex._dw_stage_cache.keys():
            ex._dw_stage_cache.pop(k)
        out["profile_stage_build"] = profile_share(ex, spec, start, end)
        for k in ("profile_warm", "profile_stage_build"):
            log(f"{k} {QUERIES[1]}: {out[k]}")

        out["obs"] = obs_phase(daemon, start, end)

        out["restart"] = restart_phase(tsdb, daemon,
                                       os.path.join(wal_dir, "wal"))
    finally:
        daemon.stop()
    return out


# ---------------------------------------------------------------------------
# HTTP ingest and tenants
# ---------------------------------------------------------------------------

def http_points():
    """HTTP_SERIES x HTTP_POINTS points, from a seed: one point every 600 s
    over the week with a jitter below it, values with three decimals."""
    rng = np.random.default_rng(9)
    ts = (BASE + np.arange(HTTP_POINTS, dtype=np.int64) * 600
          + rng.integers(0, 600, (HTTP_SERIES, HTTP_POINTS)))
    vals = np.round(rng.normal(50, 5, (HTTP_SERIES, HTTP_POINTS)), 3)
    return ts, vals


def http_bodies(metric: str, ts: np.ndarray, vals: np.ndarray) -> list:
    """/api/put bodies of at most HTTP_BODY_POINTS points: the first half
    of the series as JSON datapoint arrays, the second as put lines
    without the verb."""
    per = HTTP_BODY_POINTS // HTTP_POINTS
    half = HTTP_SERIES // 2
    bodies = []
    for a in range(0, HTTP_SERIES, per):
        rows = range(a, min(a + per, HTTP_SERIES))
        if a < half:
            bodies.append(json.dumps(
                [{"metric": metric, "timestamp": int(t), "value": float(v),
                  "tags": {"host": f"s{s:03d}"}}
                 for s in rows for t, v in zip(ts[s], vals[s])],
                separators=(",", ":")).encode())
        else:
            bodies.append("".join(
                f"{metric} {t} {v} host=s{s:03d}\n"
                for s in rows
                for t, v in zip(ts[s].tolist(), vals[s].tolist()))
                .encode())
    return bodies


def http_put_phase(port: int, start: int, end: int,
                   stage: str = "") -> dict:
    """New series through /api/put under ?tenant=smoke (JSON and put-line
    bodies, timed: the HTTP ingest rate), the same points through telnet
    on another tenant under another metric, /q of each held against the
    other, and /api/tenants: the corpus' tenant in the HLL tier within 3
    standard errors of its true count, the two new tenants exact."""
    ts, vals = http_points()
    bodies = http_bodies("smoke.http", ts, vals)
    if max(len(b) for b in bodies) > 1 << 20:
        fail("an /api/put body is over the daemon's 1 MiB bound")
    with native_calls(stage + "api_put", ("tsd_parse", "upsert_cells")):
        t0 = time.perf_counter()
        for body in bodies:
            status, resp = http_post(
                port, f"/api/put?tenant={HTTP_TENANT}", body)
            got = json.loads(resp) if status == 200 else None
            if got is None or got["errors"] or got["points"] \
                    * len(bodies) != HTTP_SERIES * HTTP_POINTS:
                fail(f"/api/put answered {status}: {resp[:300]!r}")
        http_s = time.perf_counter() - t0
    points = HTTP_SERIES * HTTP_POINTS
    lines = [f"tenant {TELNET_TENANT}"] + [
        f"put smoke.telnet {t} {v} host=s{s:03d}"
        for s in range(HTTP_SERIES)
        for t, v in zip(ts[s].tolist(), vals[s].tolist())]
    with native_calls(stage + "api_put_telnet",
                      ("tsd_parse", "upsert_cells")):
        t0 = time.perf_counter()
        said = telnet(port, lines)
        telnet_s = time.perf_counter() - t0
    if "put:" in said or not said.startswith(f"tenant {TELNET_TENANT}\n"):
        fail(f"telnet answered: {said[:500]!r}")
    out = {"http_points": points, "http_bodies": len(bodies),
           "http_body_bytes_max": max(len(b) for b in bodies),
           "http_s": http_s, "http_points_per_s": points / http_s,
           "telnet_points_per_s": points / telnet_s, "queries": {}}
    for expr in HTTP_QUERIES:
        got = {}
        for metric in ("smoke.http", "smoke.telnet"):
            m = expr.format(m=metric)
            got[metric] = http_json(port, "/q?" + urllib.parse.urlencode(
                {"start": start, "end": end, "m": m, "json": ""}))
        if len(got["smoke.http"]) != HTTP_SERIES:
            fail(f"{expr}: {len(got['smoke.http'])} groups")
        out["queries"][expr.format(m="smoke.*")] = same_answer(
            expr, got["smoke.http"], got["smoke.telnet"],
            exact=expr.startswith("max"))
    info = http_json(port, "/api/tenants")
    t = info["tenants"]
    truth = SERIES + TELNET_SERIES
    err = 3 * hll_rel_error(info["hll_p"]) * truth
    if (t["default"]["tier"] != "hll"
            or abs(t["default"]["series"] - truth) > err
            or t[HTTP_TENANT]["series"] != HTTP_SERIES
            or t[TELNET_TENANT]["series"] != HTTP_SERIES
            or t[HTTP_TENANT]["tier"] != "exact"
            or t[HTTP_TENANT]["points"] != points
            or info["tracked_series"] != truth + 2 * HTTP_SERIES
            or t["default"]["top_prefixes"][0]["prefix"] != "bench.metric"):
        fail(f"/api/tenants: {json.dumps(info)[:2000]}")
    out["api_tenants"] = {
        "tracked_series": info["tracked_series"],
        "series": {k: v["series"] for k, v in t.items()},
        "tiers": {k: v["tier"] for k, v in t.items()},
        "default_error_bound": err,
        "top_prefix": t["default"]["top_prefixes"][0],
        "top_series": t["default"]["top_series"][0]}
    log(f"/api/put: {points} points in {len(bodies)} bodies, "
        f"{out['http_points_per_s']:,.0f} points/s (telnet "
        f"{out['telnet_points_per_s']:,.0f}); /q http vs telnet "
        f"{out['queries']}; /api/tenants {out['api_tenants']}")
    return out


def refusal_phase() -> dict:
    """A small second daemon on the card with tenant_max_series=1: a new
    series refuses over telnet (the bulk path's and the per-line path's
    declared lines) and over /api/put (the 429 body naming the limit);
    the existing series keeps ingesting."""
    tsdb = open_tsdb(Config(auto_create_metrics=True, port=0,
                            bind="127.0.0.1", device=DEVICE,
                            tenant_max_series=1), None)
    daemon = Daemon(tsdb)
    try:
        port = daemon.port
        said = [telnet(port, ["tenant t", f"put lim.m {BASE} 1 id=0"]),
                telnet(port, ["tenant t", f"put lim.m {BASE + 60} 2 id=0",
                              f"put lim.m {BASE} 1 id=1"]),
                telnet(port, ["tenant t", f"put lim.m {BASE} 1 id=2"],
                       pause=True)]
        limit = ("tenant 't' series limit exceeded: 1 >= 1 (new series "
                 "refused; existing series keep ingesting)")
        want = [None, f"put: tenant series limit exceeded: lim.m: "
                f"[tenant-limit] {limit}\n",
                f"put: tenant series limit exceeded: {limit}\n"]
        for got, line in zip(said, want):
            body = got.split("\n", 1)[1].rsplit("opentsdb_tpu_torch", 1)[0]
            if line is None and "put:" in got or line and body != line:
                fail(f"telnet refusal: {got!r}")
        refused = http_post(port, "/api/put?tenant=t",
                            f"lim.m {BASE} 1 id=3\n".encode())
        kept = http_post(port, "/api/put?tenant=t",
                         f"lim.m {BASE + 120} 3 id=0\n".encode())
        body = json.loads(refused[1])
        if (refused[0] != 429 or body["limit"] != 1 or body["points"]
                or "[tenant-limit]" not in body["error"]
                or kept[0] != 200 or json.loads(kept[1])["points"] != 1):
            fail(f"/api/put refusal: {refused!r} {kept!r}")
        rows = http_get(port, "/q?" + urllib.parse.urlencode(
            {"start": BASE, "end": BASE + 3600, "m": "sum:lim.m{id=*}",
             "ascii": ""}))[1].decode().splitlines()
        ent = http_json(port, "/api/tenants")["tenants"]["t"]
        if len(rows) != 3 or ent["series"] != 1 or ent["refused"] != 3 \
                or ent["points"] != 3:
            fail(f"after the refusals: {rows} {ent}")
    finally:
        daemon.stop()
    out = {"telnet_lines": want[1:], "http_429": body,
           "tenant": {k: ent[k] for k in ("series", "refused", "points")}}
    log(f"refusal: {out}")
    return out


# ---------------------------------------------------------------------------
# Restart phase
# ---------------------------------------------------------------------------

def generation_bytes(tsdb: TSDB) -> tuple[int, int]:
    """(generations, bytes on disk) of the store's sstable tier."""
    paths = [g.path for g in tsdb.store._ssts]
    return len(paths), sum(os.path.getsize(p) for p in paths)


def gc_full_ms() -> float:
    t0 = time.perf_counter()
    gc.collect()
    return (time.perf_counter() - t0) * 1e3


def timed_checkpoint(tsdb: TSDB, what: str) -> dict:
    """One checkpoint: rows, seconds, generations, and its phases' ms
    from the ``checkpoint.phase`` timers (freeze, spill, commit)."""
    before = timer_totals("checkpoint.phase")
    t0 = time.perf_counter()
    rows = tsdb.checkpoint()
    secs = time.perf_counter() - t0
    phases = {tags.split("=")[1]: d["sum_ms"] for tags, d in timer_delta(
        before, timer_totals("checkpoint.phase")).items()}
    gens, nbytes = generation_bytes(tsdb)
    if rows <= 0 or os.path.exists(tsdb.store._wal_path + ".old"):
        fail(f"{what}: spilled {rows} rows, <wal>.old left behind")
    out = {"rows": rows, "seconds": secs, "rows_per_s": rows / secs,
           "generations": gens, "generation_bytes": nbytes,
           "phase_ms": phases}
    log(f"{what}: {rows} rows in {secs:.2f} s ({rows / secs:,.0f} rows/s), "
        f"{gens} generation(s), {nbytes} bytes, phases {phases} ms")
    return out


def same_answer(expr: str, got: list, want: list, exact: bool) -> float:
    """A JSON answer after the restart against the same query's before
    it: same groups, tags and timestamps; values equal where ``exact``,
    else within the resident tolerance (rtol 1e-5 + 1e-5 x scale).
    Returns the largest relative-to-scale difference."""
    if len(got) != len(want):
        fail(f"{expr}: {len(got)} groups after the restart, {len(want)} "
             f"before")
    worst = 0.0
    for g, w in zip(got, want):
        if g["tags"] != w["tags"] or list(g["dps"]) != list(w["dps"]):
            fail(f"{expr}: tags or timestamps changed across the restart")
        a = np.array(list(g["dps"].values()), np.float64)
        b = np.array(list(w["dps"].values()), np.float64)
        if not np.isfinite(a).all():
            fail(f"{expr}: non-finite answer after the restart")
        scale = max(float(np.abs(b).max()), 1e-30)
        err = np.abs(a - b)
        if exact and (a != b).any():
            i = int(np.argmax(err))
            fail(f"{expr}: {a[i]!r} after the restart, {b[i]!r} before")
        if (err > 1e-5 * np.abs(b) + 1e-5 * scale).any():
            fail(f"{expr}: answers differ across the restart")
        worst = max(worst, float(err.max() / scale))
    return worst


def wal_replay(tsdb: TSDB) -> dict:
    """The recovery a crash before checkpoint 1 would pay: a copy of the
    ingested store's WAL (every put since open, none spilled yet) replayed
    into a bare MemKVStore, timed. The daemon's own boot replays an empty
    WAL, since its shutdown checkpoints. The replayed tables must hold the
    live memtable's row keys."""
    store = tsdb.store
    with tempfile.TemporaryDirectory() as d:
        copy = os.path.join(d, "wal")
        with store._lock:
            store._wal.flush()
            shutil.copyfile(store._wal_path, copy)
            want = {name: set(t.rows) for name, t in store._tables.items()}
        nbytes = os.path.getsize(copy)
        with native_calls("wal_replay", ("slice_varlen", "upsert_cells")):
            t0 = time.perf_counter()
            again = MemKVStore(wal_path=copy)
            secs = time.perf_counter() - t0
        try:
            got = {name: set(t.rows) for name, t in again._tables.items()
                   if t.rows}
            if got != {name: k for name, k in want.items() if k}:
                fail("the replayed WAL holds other rows than the memtable")
            rows = sum(len(k) for k in got.values())
        finally:
            again.close()
    out = {"wal_bytes": nbytes, "rows": rows, "seconds": secs,
           "rows_per_s": rows / secs}
    log(f"WAL replay of the ingested store: {nbytes} bytes, {rows} rows "
        f"in {secs:.2f} s")
    return out


def restart_phase(tsdb: TSDB, daemon: "Daemon", wal: str) -> dict:
    """Checkpoint the ingested store, add a few hundred telnet puts and
    checkpoint again (two generations), shut the daemon down (which
    checkpoints once more), open a new TSDB and daemon on the same WAL
    (timing the generations' open, the replay and the window's warm-up
    from the tiers), then the resident queries against their answers
    from before the restart and one un-downsampled query and one host
    scan over the generations."""
    out: dict = {}
    start, end = BASE, BASE + SPAN - 1
    # One full garbage collection with the ingested memtable live, and one
    # in the restarted process (rows in the generations): the collector's
    # cost in each state, beside the warm queries' outliers.
    out["gc_full_ms"] = {"memtable": gc_full_ms()}
    out["wal_replay"] = wal_replay(tsdb)
    with native_calls("checkpoint_1", ("frame_rows_dict",)):
        out["checkpoint_1"] = timed_checkpoint(tsdb, "checkpoint 1")
    out["checkpoint_1"]["sketch_save_s"] = tsdb.sketch_save_seconds
    out["checkpoint_1"]["tenant_save_s"] = tsdb.tenant_save_seconds
    out["checkpoint_1"]["tenant_snapshot_bytes"] = tsdb.tenant_snapshot_bytes

    rng = np.random.default_rng(3)
    lines = []
    for s in range(EXTRA_SERIES):
        hours = np.sort(rng.choice(SPAN // 3600, EXTRA_POINTS,
                                   replace=False))
        tt = BASE + hours * 3600 + rng.integers(0, 3600, EXTRA_POINTS)
        for t, v in zip(tt, rng.normal(100, 1, EXTRA_POINTS)):
            lines.append(f"put bench.metric {t} {v:.4f} host=u{s:02d} "
                         f"dc=dc{s % 10}")
    with native_calls("between_checkpoints",
                      ("tsd_parse", "rows_update_new")):
        said = telnet(daemon.port, lines)
    if "put:" in said:
        fail(f"telnet puts between the checkpoints answered: "
             f"{said[:500]!r}")
    # Between the two checkpoints the window still answers; these answers
    # are the reference for after the restart.
    dw, ex = tsdb.devwindow, daemon.server.executor
    before = {expr: http_resident(daemon.port, dw, ex, expr, start, end)[1]
              for expr in QUERIES + PCT_QUERIES}
    sketch_before = sketch_answers(daemon.port, start, end)
    tenants_before = http_json(daemon.port, "/api/tenants")
    with native_calls("checkpoint_2", ("frame_rows_dict",)):
        out["checkpoint_2"] = timed_checkpoint(tsdb, "checkpoint 2")
    if out["checkpoint_2"]["generations"] != 2:
        fail(f"{out['checkpoint_2']['generations']} generations after two "
             f"checkpoints")

    t0 = time.perf_counter()
    daemon.stop()
    out["shutdown_s"] = time.perf_counter() - t0
    with native_calls("boot", ("slice_varlen",)):
        t0 = time.perf_counter()
        tsdb2 = open_daemon_tsdb(wal)
        store = tsdb2.store
        out["boot_s"] = time.perf_counter() - t0
    out["open_generations_s"] = store.open_seconds["generations"]
    out["replay_s"] = store.open_seconds["replay"]
    out["warm_s"] = tsdb2.warm_seconds
    out["sketch_load_s"] = tsdb2.sketch_load_seconds
    out["tenant_load_s"] = tsdb2.tenant_load_seconds
    if tsdb2.tenants.rebuilt:
        fail("the restarted daemon rebuilt tenant accounting instead of "
             "loading its snapshot")
    out["generations"], out["generation_bytes"] = generation_bytes(tsdb2)
    dw2 = tsdb2.devwindow
    points = SERIES * POINTS + TELNET_SERIES * TELNET_POINTS \
        + EXTRA_SERIES * EXTRA_POINTS + 2 * HTTP_SERIES * HTTP_POINTS
    if dw2 is None or dw2.appended_points != points:
        fail(f"the window warmed {dw2 and dw2.appended_points} of {points} "
             f"points from the tiers")
    log(f"restart: shutdown {out['shutdown_s']:.1f} s; boot "
        f"{out['boot_s']:.1f} s (generations {out['open_generations_s']:.2f}"
        f" s, replay {out['replay_s']:.2f} s, window warm-up "
        f"{out['warm_s']:.1f} s, sketch snapshot load "
        f"{out['sketch_load_s']:.3f} s, saved in checkpoint 1 in "
        f"{out['checkpoint_1']['sketch_save_s']:.3f} s; tenant snapshot "
        f"load {out['tenant_load_s']:.3f} s, saved in checkpoint 1 in "
        f"{out['checkpoint_1']['tenant_save_s']:.3f} s, "
        f"{out['checkpoint_1']['tenant_snapshot_bytes']} bytes); "
        f"{out['generations']} generations, {out['generation_bytes']} "
        f"bytes")

    out["gc_full_ms"]["after_restart"] = gc_full_ms()
    log(f"full gc, heap frozen at each open: {out['gc_full_ms']} (before "
        f"the daemon froze it: {GC_FULL_MS_UNTUNED})")
    daemon2 = Daemon(tsdb2)
    try:
        ex2 = daemon2.server.executor
        # The loaded tenant snapshot answers as the daemon did before the
        # restart, but for the count of snapshots this process wrote.
        tenants_after = http_json(daemon2.port, "/api/tenants")
        if {k: v for k, v in tenants_after.items()
                if k != "snapshots_written"} != {
                k: v for k, v in tenants_before.items()
                if k != "snapshots_written"}:
            fail(f"/api/tenants changed across the restart: "
                 f"{json.dumps(tenants_after)[:1000]} vs "
                 f"{json.dumps(tenants_before)[:1000]}")
        out["tenants_same_after_restart"] = True
        out["queries"] = {}
        zero_launches()
        for expr in QUERIES + PCT_QUERIES:
            runs = [http_resident(daemon2.port, dw2, ex2, expr, start, end)
                    for _ in range(1 + WARM_REPS)]
            exact = (expr in PCT_QUERIES
                     or spec_of(expr).aggregator in ("min", "max", "count"))
            worst = max(same_answer(expr, a, before[expr], exact)
                        for _, a in runs)
            out["queries"][expr] = {
                "first_ms": runs[0][0]["wall_ms"],
                "warm_p50_ms": statistics.median(
                    r["wall_ms"] for r, _ in runs[1:]),
                "warm_ms": [r["wall_ms"] for r, _ in runs[1:]],
                "exact": exact, "rel_diff_vs_before": worst}
        out["launches_resident"] = path_launches(
            "resident path after the restart", KERNELS[:3])

        # The sketch routes answer from the loaded snapshot (the memtable
        # is empty): byte for byte their answers from before the restart.
        zero_sketch_launches()
        after = sketch_answers(daemon2.port, start, end)
        for name, a in after.items():
            if a["body"] != sketch_before[name]["body"]:
                fail(f"sketch {name}: {a['body'][:200]!r} after the "
                     f"restart, {sketch_before[name]['body'][:200]!r} "
                     f"before")
        out["launches_sketch"] = sketch_launches()
        for name in ("hll_fold", "hll_estimate", "merged_quantile"):
            if out["launches_sketch"][name] == 0:
                fail(f"the sketch routes after the restart never "
                     f"launched {name}")
        out["sketch"] = {name: {"wall_ms": a["wall_ms"],
                                "wall_ms_before": sketch_before[name][
                                    "wall_ms"], "same_bytes": True}
                         for name, a in after.items()}

        zero_launches()
        store = tsdb2.store
        skipped0 = store.bloom_files_skipped
        first_union = http_union(daemon2.port, RESTART_UNION, start, end)
        answer, out["union"], _ = first_union
        out["launches_union"] = path_launches(
            "union query after the restart", ("interp_moments",))
        # The candidate-series hint of {host=h00001} against each
        # generation's series bloom: checkpoint 2's generation holds only
        # the telnet u-series, so its chunk scans must skip it.
        spec = spec_of(RESTART_UNION)
        hint = ex2._series_hint(tsdb2.metrics.get_id(spec.metric),
                                *ex2._tag_filters(spec.tags))
        without = sum(not g.bloom_may_contain(tsdb2.table, hint)
                      for g in store._ssts)
        out["bloom"] = {"generations": len(store._ssts),
                        "generations_without_h00001": without,
                        "files_skipped": store.bloom_files_skipped
                        - skipped0}
        if (without > 0) != (out["bloom"]["files_skipped"] > 0):
            fail(f"{RESTART_UNION}: bloom skips {out['bloom']}")
        if without == 0:
            log(f"no generation lacks h00001's series ({len(store._ssts)} "
                f"generations): nothing for the bloom to skip")
        s0 = time.perf_counter()
        info: dict = {}
        week = ex2._find_spans(spec_of("sum:bench.metric{host=*}"), start,
                               end, info)
        out["generation_scan_ms"] = (time.perf_counter() - s0) * 1e3
        if info.get("cached"):
            fail("the first {host=*} scan after the restart was cached")
        # The same scan again, now from the fragments: the same spans,
        # array for array.
        s0 = time.perf_counter()
        info = {}
        warm = ex2._find_spans(spec_of("sum:bench.metric{host=*}"), start,
                               end, info)
        out["generation_scan_warm_ms"] = (time.perf_counter() - s0) * 1e3
        if not info.get("cached") or sorted(warm) != sorted(week) or any(
                not (np.array_equal(a.timestamps, b.timestamps)
                     and np.array_equal(a.values, b.values))
                for g in week for a, b in zip(week[g], warm[g])):
            fail("the warm {host=*} scan differs from the cold one")
        del warm
        spans = [sp for g in sorted(week) for sp in week[g]]
        out["union"]["oracle_rel_err"] = check_answer(
            RESTART_UNION, answer,
            QueryExecutor(tsdb2, backend="cpu")._execute_groups(
                spec, regroup(ex2, spans, spec.tags), start, end),
            1e-4, "oracle")
        log(f"host scan of every series over the week from the "
            f"generations: {out['generation_scan_ms']:.0f} ms cold, "
            f"{out['generation_scan_warm_ms']:.0f} ms from the fragment "
            f"cache, {len(spans)} spans")
        del week, spans

        # Repeats served from the fragment cache, byte for byte: the
        # un-downsampled queries (their kernels launched again) and the
        # ranged sketch routes, whose first runs came just after boot.
        zero_launches()
        out["repeats"] = {RESTART_UNION: repeat_union(
            daemon2.port, RESTART_UNION, start, end, first_union)}
        for expr, span in UNION_QUERIES[1:3]:
            out["repeats"][expr] = repeat_union(daemon2.port, expr, start,
                                                start + span - 1)
        out["launches_repeats"] = path_launches(
            "cached repeats after the restart",
            ("masked_select", "interp_moments"))
        again = sketch_answers(daemon2.port, start, end)
        for name in ("ranged dc0", "ranged distinct dc0"):
            if again[name]["body"] != after[name]["body"]:
                fail(f"sketch {name}: the repeat's body differs")
            out["repeats"][name] = {"first_ms": after[name]["wall_ms"],
                                    "repeat_ms": again[name]["wall_ms"],
                                    "same_bytes": True}
        out["qcache"] = qcache_counters(ex2, store)
        log(f"fragment cache after the restart: {out['qcache']}; bloom "
            f"{out['bloom']}; repeats {out['repeats']}")
        stats = stat_lines(daemon2.port)
        out["timers"] = {name: timer_lines(stats, name) for name in (
            "wal.append", "wal.fsync", "ingest.parse", "checkpoint.phase")}
        log(f"timers from /stats after the restart: {out['timers']}")
        out["fsck"] = fsck_clean(tsdb2, "the one-shard store")
    finally:
        daemon2.stop()
    out["marker_rebuild"] = marker_rebuild(wal, tenants_before)
    return out


def marker_rebuild(wal: str, want: dict) -> dict:
    """The store as the port left it before it kept tenant accounting: a
    version-0 tenant file in place of the snapshot. An open rebuilds from
    all of storage (timed: the one-time cost of the transition), with
    exact totals on the default tenant, and its checkpoint writes a real
    snapshot."""
    path = wal + ".tenants.json"
    with open(path, "w") as f:
        json.dump(OLD_TENANT_MARKER, f)
    tsdb = open_tsdb(Config(auto_create_metrics=True, device=DEVICE,
                            device_window=False), wal)
    try:
        acct = tsdb.tenants
        info = acct.snapshot_info()
        total = want["tracked_series"]
        est = info["tenants"]["default"]["series"]
        if (not acct.rebuilt or info["tracked_series"] != total
                or info["total_series"] != total
                or acct.recovered_series != total
                or abs(est - total) > 3 * hll_rel_error(info["hll_p"])
                * total):
            fail(f"the rebuild over the old marker: {info}")
        out = {"rebuild_s": tsdb.tenant_load_seconds, "series": total,
               "default_estimate": est}
        tsdb.checkpoint()
        with open(path) as f:
            out["snapshot_version_after_checkpoint"] = json.load(f)[
                "version"]
        if out["snapshot_version_after_checkpoint"] != 1:
            fail("the checkpoint after the rebuild wrote no snapshot")
    finally:
        tsdb.shutdown()
    log(f"tenant rebuild over the old version-0 marker: {out}")
    return out


# ---------------------------------------------------------------------------
# The sharded store
# ---------------------------------------------------------------------------

def fsck_clean(tsdb: TSDB, what: str) -> dict:
    """``tools/fsck.run_fsck`` over the store (timed); any error fails."""
    t0 = time.perf_counter()
    rep = run_fsck(tsdb)
    out = {"rows": rep.rows, "kvs": rep.kvs, "errors": rep.errors,
           "bloomed": rep.bloomed, "seconds": time.perf_counter() - t0}
    if rep.errors or not rep.rows:
        fail(f"fsck of {what}: {out}")
    log(f"fsck of {what}: clean, {rep.rows} rows in {out['seconds']:.1f} s")
    return out


def writer_during(tsdb: TSDB, action, series: int, points: int,
                  seed: int) -> dict:
    """A writer thread ingests ``series`` new series (``bench.writer``,
    one add_batch each); once a quarter of them are in, ``action`` (a
    checkpoint) runs on this thread. Returns the action's result and
    seconds, and the writer's add_batch calls that overlapped it: the
    longest is the pause a writer saw."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(50, 5, (series, points))
    base = BASE + np.arange(points, dtype=np.int64) * (SPAN // points)
    calls: list[tuple[float, float]] = []
    quarter = threading.Event()
    errs: list = []

    def write():
        for s in range(series):
            c0 = time.perf_counter()
            tsdb.add_batch("bench.writer", base + s % 600, vals[s],
                           {"host": f"w{s:04d}"})
            calls.append((c0, time.perf_counter()))
            if s + 1 == series // 4:
                quarter.set()

    th = threading.Thread(target=lambda: _catch(write, errs))
    th.start()
    quarter.wait(600)
    a0 = time.perf_counter()
    result = action()
    a1 = time.perf_counter()
    th.join(600)
    if errs:
        raise errs[0]
    during = [b - a for a, b in calls if b > a0 and a < a1]
    outside = [b - a for a, b in calls if b <= a0 or a >= a1]
    return {"result": result, "seconds": a1 - a0,
            "writer_calls_during": len(during),
            "longest_add_batch_ms": max(during, default=0.0) * 1e3,
            "median_add_batch_ms_outside": statistics.median(outside) * 1e3
            if outside else None}


def writer_pause_phase(ts: np.ndarray, vals: np.ndarray) -> dict:
    """1 shard against SHARDS with group commit off (the default Config
    otherwise): each store takes the whole corpus through ``add_batch``
    (timed: what the shard count alone does to ingest), then checkpoints
    that full memtable while a writer ingests WRITER_SERIES more (the
    pause a writer sees). The corpus' first PAUSE_SERIES series only."""
    out = {}
    ts, vals = ts[:PAUSE_SERIES], vals[:PAUSE_SERIES]
    for shards in (1, SHARDS):
        with tempfile.TemporaryDirectory() as d:
            tsdb = open_tsdb(Config(auto_create_metrics=True, device=DEVICE),
                             os.path.join(d, "store"), shards=shards)
            try:
                t0 = time.perf_counter()
                for s in range(len(ts)):
                    tsdb.add_batch("bench.metric", ts[s], vals[s],
                                   series_tags(s))
                ingest_s = time.perf_counter() - t0
                got = writer_during(tsdb, tsdb.checkpoint, WRITER_SERIES,
                                    WRITER_POINTS, seed=31)
                got["ingest_s"] = ingest_s
                got["add_batch_points_per_s"] = ts.size / ingest_s
                got["rows"] = got.pop("result")
                got["spill_s"] = list(getattr(tsdb.store, "spill_seconds",
                                              [got["seconds"]]))
                out[f"shards_{shards}"] = got
            finally:
                tsdb.shutdown()
    log(f"writer pause during a checkpoint, 1 vs {SHARDS} shards: {out}")
    return out


def sharded_phase(ts: np.ndarray, vals: np.ndarray) -> dict:
    """The daemon over a SHARDS-shard store under WAL group commit: the
    corpus (as wire batches of BARRIER_SERIES series), the telnet and
    /api/put ingest; the resident and un-downsampled /q answers held
    against the one-shard daemon's (REFERENCE: tags and timestamps
    identical, max and percentiles exact, sums at the resident
    tolerance); two checkpoints (per-shard spill seconds; a writer
    ingests during the second); a restart on the same directory (boot
    seconds), the resident answers and {host=h00001}'s again, the cold
    {host=*} week scan, the shard
    skip of {host=h00001} and fsck."""
    start, end = BASE, BASE + SPAN - 1
    out: dict = {"shards": SHARDS, "wal_group_ms": WAL_GROUP_MS}
    with tempfile.TemporaryDirectory() as d:
        root = os.path.join(d, "store")
        tsdb = open_daemon_tsdb(root, shards=SHARDS,
                                wal_group_ms=WAL_GROUP_MS)
        store = tsdb.store
        if getattr(store, "shard_count", 1) != SHARDS \
                or store.wal_group_ms != WAL_GROUP_MS:
            fail(f"the sharded daemon opened {type(store).__name__}")
        daemon = Daemon(tsdb)
        try:
            f0, t0 = store.wal_group_flushes, time.perf_counter()
            out["ingest"], _ = ingest(tsdb, daemon.port, ts, vals,
                                      stage="sharded_",
                                      barrier_series=BARRIER_SERIES)
            out["tenants"] = http_put_phase(daemon.port, start, end,
                                            stage="sharded_")
            secs = time.perf_counter() - t0
            out["group_flushes"] = store.wal_group_flushes - f0
            out["group_flushes_per_s"] = out["group_flushes"] / secs
            out["answers"] = compare_reference(daemon, tsdb, start, end,
                                               UNION_QUERIES)
            sexpr, span = OBS_SCAN_QUERY
            wall, answer = traced_q(daemon.port, sexpr, start,
                                    start + span - 1, True)
            for g in answer:
                check_scan_tree(g["trace"], sexpr, SHARDS)
                check_children_fit(g["trace"], sexpr)
            out["traced_scan"] = {"query": sexpr, "wall_ms": wall,
                                  "trace": answer[0]["trace"]}
            split0 = {n: timer_totals(n) for n in (
                "checkpoint.phase", "checkpoint.shard_spill")}
            with native_calls("sharded_checkpoint_1", ("frame_rows_dict",)):
                c0 = time.perf_counter()
                rows = tsdb.checkpoint()
                out["checkpoint_1"] = {
                    "rows": rows, "seconds": time.perf_counter() - c0,
                    "spill_s": list(store.spill_seconds)}
            with native_calls("sharded_checkpoint_2", ("frame_rows_dict",)):
                got = writer_during(tsdb, tsdb.checkpoint, WRITER_SERIES,
                                    WRITER_POINTS, seed=37)
            got["rows"] = got.pop("result")
            got["spill_s"] = list(store.spill_seconds)
            out["checkpoint_2"] = got
            if out["checkpoint_1"]["rows"] <= 0 or got["rows"] <= 0:
                fail(f"sharded checkpoints spilled nothing: {out}")
            log(f"sharded checkpoints: {out['checkpoint_1']}, {got}")
            # The two checkpoints' split: the phases' and each shard's
            # spill (count and ms summed over both), and the lines of the
            # daemon's /stats.
            stats = stat_lines(daemon.port)
            out["checkpoint_split"] = {
                n: timer_delta(split0[n], timer_totals(n)) for n in split0}
            out["checkpoint_split_stats"] = {n: timer_lines(stats, n)
                                             for n in split0}
            spills = out["checkpoint_split"]["checkpoint.shard_spill"]
            if sorted(spills) != [f"shard={i}" for i in range(SHARDS)] \
                    or any(v["count"] != 2 for v in spills.values()):
                fail(f"checkpoint.shard_spill after two checkpoints: "
                     f"{spills}")
            log(f"sharded checkpoint split: {out['checkpoint_split']}")
            t0 = time.perf_counter()
            daemon.stop()
            out["shutdown_s"] = time.perf_counter() - t0
            with native_calls("sharded_boot", ("slice_varlen",)):
                t0 = time.perf_counter()
                tsdb = open_daemon_tsdb(root, wal_group_ms=WAL_GROUP_MS)
                out["boot_s"] = time.perf_counter() - t0
            store = tsdb.store
            if store.shard_count != SHARDS or tsdb.tenants.rebuilt:
                fail("the restarted sharded daemon did not reopen its "
                     "shards and tenant snapshot")
            out["warm_s"] = tsdb.warm_seconds
            out["open_seconds"] = store.open_seconds
            daemon = Daemon(tsdb)
            ex = daemon.server.executor
            # After the restart the un-downsampled query whose scans the
            # shard skip prunes (the week-long sum alone takes ~15 s).
            out["answers_after_restart"] = compare_reference(
                daemon, tsdb, start, end,
                [q for q in UNION_QUERIES if q[0] == RESTART_UNION])
            s0 = time.perf_counter()
            info: dict = {}
            week = ex._find_spans(spec_of("sum:bench.metric{host=*}"),
                                  start, end, info)
            out["host_week_scan_cold_ms"] = (time.perf_counter() - s0) * 1e3
            if info.get("cached") or \
                    sum(map(len, week.values())) != SERIES + TELNET_SERIES:
                fail("the cold {host=*} week scan over the shards")
            del week
            # {host=h00001}'s series hint names one series: each of its
            # chunk scans skips the other SHARDS - 1 shards.
            out["bloom_shards_skipped"] = out["answers_after_restart"][
                "union"][RESTART_UNION]["shards_skipped"]
            if out["bloom_shards_skipped"] <= 0 or \
                    out["bloom_shards_skipped"] % (SHARDS - 1):
                fail(f"{RESTART_UNION}: bloom_shards_skipped "
                     f"{out['bloom_shards_skipped']}")
            out["fsck"] = fsck_clean(tsdb, f"the {SHARDS}-shard store")
        finally:
            daemon.stop()
    return out


# ---------------------------------------------------------------------------
# Compressed phase: TSST4 generations, the fused plan, the decode kernel
# ---------------------------------------------------------------------------

def decode_launches() -> tuple:
    return launches() + (block_decode.decode_points.launches,)


def zero_decode_launches() -> None:
    zero_launches()
    block_decode.decode_points.launches = 0


FUSED_KERNELS = KERNELS + ("block_decode",)


def int_lines() -> list:
    """INT_SERIES integer series (bench.int) over the week, from a seed:
    the telnet lines of the TSINT leg."""
    rng = np.random.default_rng(23)
    t = BASE + np.arange(0, SPAN, INT_STEP, dtype=np.int64)
    lines = []
    for s in range(INT_SERIES):
        v = rng.integers(-1000, 10_000, len(t))
        lines.extend(f"put bench.int {a} {b} host=i{s:03d}"
                     for a, b in zip(t.tolist(), v.tolist()))
    return lines


def gather_streams(store, table: str, metric_uid: bytes, b_lo: int,
                   b_hi: int, dev) -> tuple:
    """A gather's decode inputs as the fused byte-stream leg uploads them
    (pad_fine points, power-of-two payloads), on ``dev``; and the
    gather's point count and value kind."""
    src = cfused.gather(store, table, metric_uid, b_lo, b_hi)
    P_pad = pad_fine(src.npoints)

    def pad(a):
        out = np.zeros(P_pad, np.int32)
        out[:len(a)] = a
        return torch.from_numpy(out).to(dev)

    def padbuf(a):
        n = max(len(a), 1)
        out = np.zeros(1 << (n - 1).bit_length(), np.uint8)
        out[:len(a)] = a
        return torch.from_numpy(out).to(dev)

    args = (pad(src.ts_nb), padbuf(src.ts_pay), pad(src.v_nb),
            padbuf(src.v_pay), pad(src.first_idx), pad(src.blk_first),
            pad(src.rel_base_pt))
    return args, src.npoints, src.kind


# One decode per (padded points, value kind) pair of argv under
# torch.profiler, in a fresh process: one JSON line each, the CUDA
# kernels it launched and the memsets it made.
DECODE_COUNT = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from opentsdb_tpu_torch.ops import block_decode
from opentsdb_tpu_torch.tools.compare_kernels import decode_inputs
for n, vkind in zip(sys.argv[1::2], sys.argv[2::2]):
    args = decode_inputs(torch.device("cuda"), int(n), seed=5)
    block_decode.decode_points(*args, vkind=vkind)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        block_decode.decode_points(*args, vkind=vkind)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    memsets = [n for n in names if "memset" in n.lower()]
    kernels = [n for n in names
               if n not in memsets and "memcpy" not in n.lower()]
    print(json.dumps({"kernels_per_call": len(kernels),
                      "memsets_per_call": len(memsets),
                      "kernel_names": sorted(set(kernels))}))
    del args
"""


def count_decode_kernels(cases: list) -> None:
    """Each decode case's kernels and memsets in one call, counted under
    torch.profiler in a child process on a gather of the case's size and
    kind (compare_kernels' decode_inputs; the count does not depend on
    the data): at most DECODE_MAX_KERNELS kernels and no memset. In this
    process, right after the plain version's run, the profiler has shown
    no device activity at all for one decode on the card, while a fresh
    process records both kernels."""
    root = os.path.dirname(os.path.abspath(__file__))
    argv = [str(x) for r in cases for x in (r["padded_points"], r["vkind"])]
    out = subprocess.run([sys.executable, "-c", DECODE_COUNT, *argv],
                         cwd=root, env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"the decode's kernel count failed: {out.stderr[-2000:]}")
    counts = [json.loads(ln) for ln in out.stdout.splitlines()
              if ln.startswith("{")]
    if len(counts) != len(cases):
        fail(f"the decode's kernel count printed {out.stdout[-2000:]}")
    for r, c in zip(cases, counts):
        r.update(c)
        if not 0 < c["kernels_per_call"] <= DECODE_MAX_KERNELS \
                or c["memsets_per_call"]:
            fail(f"block_decode {r['stage']}: one call made {c}")


def decode_case(stage: str, args: tuple, npoints: int, vkind: str,
                flush: torch.Tensor) -> dict:
    """The decode kernel on one gather against decode_points_plain on the
    same card tensors: rel_ts and the value bits identical on every
    point (padding included), then timed like the other kernels
    (count_decode_kernels counts its launches). Bytes: every input read
    once, both outputs written once."""
    fn = block_decode.decode_points
    got = fn(*args, vkind=vkind)
    want = block_decode.decode_points_plain(*args, vkind=vkind)
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]) or not torch.equal(
            got[1].view(torch.int32), want[1].view(torch.int32)):
        fail(f"block_decode {stage}: the kernel's output differs from "
             f"decode_points_plain")
    del got, want
    n = args[0].numel()
    nbytes = sum(a.numel() * a.element_size() for a in args) + 8 * n
    b_ms, b_by = bound_ms(nbytes, 0.0)
    rec = {"name": "block_decode", "stage": stage, "points": npoints,
           "padded_points": n, "vkind": vkind,
           "payload_bytes": args[1].numel() + args[3].numel(),
           "max_abs_err": 0.0,
           "ms": median_ms(lambda: fn(*args, vkind=vkind)),
           "ms_cold": median_ms(lambda: fn(*args, vkind=vkind),
                                flush=flush),
           "ms_device": device_ms(lambda: fn(*args, vkind=vkind)),
           "plain_ms": median_ms(lambda: block_decode.decode_points_plain(
               *args, vkind=vkind), reps=5),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "library": NO_LIBRARY, "bytes": nbytes}
    log(f"block_decode {stage}: {rec}")
    return rec


def http_fused(port: int, expr: str, start: int, end: int,
               plan: str = "fused") -> tuple[dict, list, bytes]:
    """One /q run whose every group must carry ``plan``; the run's wall
    ms and kernel launches."""
    target = "/q?" + urllib.parse.urlencode(
        {"start": start, "end": end, "m": expr, "json": ""})
    before = decode_launches()
    q0 = time.perf_counter()
    status, body = http_get(port, target)
    wall = (time.perf_counter() - q0) * 1e3
    if status != 200:
        fail(f"{expr}: HTTP {status}: {body[:300]!r}")
    answer = json.loads(body)
    if not answer or any(g["rollup"] != plan for g in answer):
        fail(f"{expr}: not served {plan}: "
             f"{sorted({g.get('rollup') for g in answer})}")
    return ({"wall_ms": wall,
             **{k: a - b for k, a, b in zip(FUSED_KERNELS,
                                             decode_launches(), before)}},
            answer, body)


def devcache_counts() -> dict:
    return {k: METRICS.counter(f"compress.devcache.{k}").value
            for k in ("hit", "miss", "evict")}


def decline_count(reason: str) -> int:
    return METRICS.counter("compress.fused.decline",
                           {"reason": reason}).value


def leg_runs(daemon: "Daemon", ex: QueryExecutor) -> dict:
    """One day of sum:1h-avg through each leg of the fused plan, cold
    (its stage cache emptied first) then warm: the byte-stream leg
    (device block cache off), the cache's miss, its hit; and
    max:1h-max{host=h00001}'s selector legs (bytes, the cache's miss and
    hit)."""
    start, end = BASE, BASE + DAY - 1
    out = {}
    saved = ex._devcache

    def run(label, expr, cache, want):
        ex._devcache = cache
        ex._fused_stage_cache.clear()
        c0 = devcache_counts()
        cold, answer, _ = http_fused(daemon.port, expr, start, end)
        warm, again, _ = http_fused(daemon.port, expr, start, end)
        c1 = devcache_counts()
        delta = {k: c1[k] - c0[k] for k in c0}
        if warm["block_decode"]:
            fail(f"{label}: the warm run decoded again")
        out[label] = {"query": expr, "cold_ms": cold["wall_ms"],
                      "warm_ms": warm["wall_ms"],
                      "cold_launches": {k: cold[k] for k in FUSED_KERNELS},
                      "devcache": delta}
        for k, n in want.items():
            if delta[k] != n:
                fail(f"{label}: devcache {k} {delta[k]}, not {n}")
        if cache is not None and delta["hit"] + delta["miss"] != 1:
            fail(f"{label}: devcache {delta}: not one lookup")
        if cache is None and cold["block_decode"] != 1:
            fail(f"{label}: the byte-stream leg decoded "
                 f"{cold['block_decode']} times")
        if again != answer:
            fail(f"{label}: the warm answer differs from the cold one")
        return answer

    try:
        day = "sum:1h-avg:bench.metric"
        host = "max:1h-max:bench.metric{host=h00001}"
        a = run("bytes", day, None, {"hit": 0, "miss": 0})
        b = run("devcache_miss", day, saved, {"hit": 0, "miss": 1})
        c = run("devcache_hit", day, saved, {"hit": 1, "miss": 0})
        out["same_answer_max_rel_diff"] = max(
            same_answer(day, b, a, False), same_answer(day, c, a, True))
        # The selector gathers only the blocks holding h00001's records:
        # where that is fewer blocks than the day's, another cache entry
        # (a miss), else the day's (a hit).
        d = run("bytes_sel", host, None, {"hit": 0, "miss": 0})
        e = run("devcache_sel_first", host, saved, {})
        f = run("devcache_sel_hit", host, saved, {"hit": 1, "miss": 0})
        if not d == e == f:
            fail(f"{host}: the selector legs answer differently")
    finally:
        ex._devcache = saved
    log(f"fused legs over one day: {out}")
    return out


def gather_host_ms(tsdb: TSDB) -> dict:
    """The week's gather of bench.metric on the host: with every block's
    parsed keys dropped (the cold query's first step, ``_prep_keys`` in
    Python over every record) and with them kept (points=False, as the
    device-cache leg gathers)."""
    uid = tsdb.metrics.get_id("bench.metric")
    b_lo, b_hi = BASE, BASE + SPAN - 1 - (BASE + SPAN - 1) % 3600
    for g in tsdb.store._ssts:
        g.__dict__.pop("_fused_prep", None)
    t0 = time.perf_counter()
    src = cfused.gather(tsdb.store, tsdb.table, uid, b_lo, b_hi,
                        points=False)
    cold = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cfused.gather(tsdb.store, tsdb.table, uid, b_lo, b_hi, points=False)
    warm = (time.perf_counter() - t0) * 1e3
    records = sum(prep.n for _, _, prep, *_ in src.blocks)
    out = {"cold_ms": cold, "warm_ms": warm, "blocks": len(src.blocks),
           "records": records, "points": src.npoints}
    log(f"week gather on the host: {out}")
    return out


def open_compressed_tsdb(wal: str) -> TSDB:
    tsdb = open_tsdb(Config(auto_create_metrics=True, port=0,
                            bind="127.0.0.1", device=DEVICE,
                            sstable_codec="tsst4", device_window=False),
                     wal)
    tune_for_ingest()
    if tsdb.devwindow is not None or tsdb.store.sstable_codec != "tsst4":
        fail("the compressed daemon's TSDB came up with the window or "
             "without the tsst4 codec")
    return tsdb


def fused_queries(daemon: "Daemon", start: int, end: int,
                  warm_reps: int) -> tuple[dict, dict]:
    """The ten queries over HTTP, each once cold and ``warm_reps`` times
    warm: every group fused. Returns (runs, answers)."""
    runs, answers = {}, {}
    for expr in QUERIES + PCT_QUERIES:
        rs = []
        for _ in range(1 + warm_reps):
            run, answers[expr], _ = http_fused(daemon.port, expr, start,
                                               end)
            rs.append(run)
        runs[expr] = {"first_ms": rs[0]["wall_ms"],
                      "first_launches": {k: rs[0][k] for k in FUSED_KERNELS},
                      "warm_ms": [r["wall_ms"] for r in rs[1:]]}
        log(f"fused {expr}: {runs[expr]}")
    return runs, answers


def compressed_phase(ts: np.ndarray, vals: np.ndarray, path: dict) -> dict:
    """See 5d in the module docstring."""
    start, end = BASE, BASE + SPAN - 1
    out: dict = {}
    dev = torch.device(DEVICE)
    with tempfile.TemporaryDirectory() as d:
        wal = os.path.join(d, "wal")
        tsdb = open_compressed_tsdb(wal)
        daemon = Daemon(tsdb)
        try:
            t0 = time.perf_counter()
            for s in range(SERIES):
                tsdb.add_batch("bench.metric", ts[s], vals[s],
                               series_tags(s))
            lines, _ = telnet_corpus_lines()
            said = telnet(daemon.port, lines + int_lines())
            if "put:" in said:
                fail(f"compressed ingest answered {said[:300]!r}")
            n_int = INT_SERIES * len(range(0, SPAN, INT_STEP))
            points = SERIES * POINTS + len(lines) + n_int
            ingest_s = time.perf_counter() - t0
            out["ingest"] = {"points": points, "seconds": ingest_s,
                             "points_per_s": points / ingest_s}
            ck = out["checkpoint_1"] = timed_checkpoint(
                tsdb, "compressed checkpoint 1")
            raw, stored = tsdb.store.compress_stats()
            ratio = stat_lines(daemon.port).get("tsd.compress.ratio")
            if not ratio or not raw > stored > 0:
                fail(f"no compress.ratio after checkpoint 1: {ratio}")
            v3 = path["restart"]["checkpoint_1"]
            out["bytes"] = {
                "v4_file_bytes": ck["generation_bytes"],
                "v4_record_bytes": stored, "raw_record_bytes": raw,
                "compress_ratio": next(iter(ratio.values())),
                "path_phase_v3_file_bytes": v3["generation_bytes"],
                "path_phase_v3_rows": v3["rows"],
                "formats": tsdb.store.sstable_format_bytes()}
            log(f"compressed checkpoint 1: {out['bytes']}")

            # The decode kernel at three gathers of this store.
            flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                                device=dev)
            cases = []
            week_hi = end - end % 3600
            for stage, metric, b_lo, b_hi in (
                    ("week gather (TSF32)", "bench.metric", BASE,
                     week_hi),
                    ("one-day gather (TSF32)", "bench.metric", BASE,
                     BASE + DAY - 3600),
                    ("week gather (TSINT)", "bench.int", BASE, week_hi)):
                args, npts, kind = gather_streams(
                    tsdb.store, tsdb.table, tsdb.metrics.get_id(metric),
                    b_lo, b_hi, dev)
                if kind != ("int" if metric == "bench.int" else "f32"):
                    fail(f"{metric}: gathered {kind} blocks")
                cases.append(decode_case(stage, args, npts, kind, flush))
                del args
            cases.append(decode_case(
                "synthetic long-record gather (TSF32, 360-point records)",
                decode_inputs(dev, LONG_RECORD_GATHER_POINTS, seed=31),
                LONG_RECORD_GATHER_POINTS, "f32", flush))
            del flush
            count_decode_kernels(cases)
            out["kernel_cases"] = cases

            # The fused path: the ten queries, launches counted.
            zero_decode_launches()
            out["queries"], answers = fused_queries(
                daemon, start, end, FUSED_WARM_REPS)
            got = dict(zip(FUSED_KERNELS, decode_launches()))
            for k in ("segment_sum", "masked_select", "block_decode"):
                if got[k] == 0:
                    fail(f"the fused path never launched {k}")
            out["launches"] = got
            for expr in QUERIES + PCT_QUERIES:
                q = out["queries"][expr]
                q["resident_max_rel_diff"] = same_answer(
                    expr, answers[expr], REFERENCE["resident"][expr],
                    False)
                q["oracle_rel_err"] = check_answer(
                    expr, answers[expr], REFERENCE["oracle"][expr], 1e-4,
                    "oracle")
            ex = daemon.server.executor
            iexpr = "sum:1h-sum:bench.int"
            irun, ians, _ = http_fused(daemon.port, iexpr, start, end)
            tsdb.config.sstable_fused_agg = False
            try:
                _, iraw, _ = http_fused(daemon.port, iexpr, start, end,
                                        plan="raw")
            finally:
                tsdb.config.sstable_fused_agg = True
            if [(g["tags"], g["dps"]) for g in ians] \
                    != [(g["tags"], g["dps"]) for g in iraw]:
                fail(f"{iexpr}: the fused answer is not the raw scan's")
            out["int_query"] = {"query": iexpr, "ms": irun["wall_ms"],
                                "block_decode": irun["block_decode"],
                                "equal_to_raw": True}
            out["legs"] = leg_runs(daemon, ex)
            # The card's share of one fused query's wall time, its stage
            # built (the week's columns decoded: too large for the device
            # cache) and from the stage cache.
            spec = spec_of(QUERIES[1])
            ex._fused_stage_cache.clear()
            out["profile_cold"] = profile_share(ex, spec, start, end,
                                                "fused")
            out["profile_warm"] = profile_share(ex, spec, start, end,
                                                "fused")
            log(f"fused {QUERIES[1]} under the profiler: cold "
                f"{out['profile_cold']}, warm {out['profile_warm']}")
            # The decode's share of a cold sum:1h-avg's card time: the
            # decode kernels in the trace, and, in case the trace misses
            # them (count_decode_kernels), the week case's ms_device
            # over the trace's busy ms plus it (the query decodes that
            # same gather).
            ex._fused_stage_cache.clear()
            cold = out["profile_cold_sum"] = profile_share(
                ex, spec_of(QUERIES[0]), start, end, "fused",
                match=("decode_main", "decode_general"))
            week_ms = cases[0]["ms_device"]
            busy = cold["device_busy_ms"]
            if isinstance(busy, float):
                seen = cold["matched_ms"] if cold["matched_ms"] else 0.0
                cold["week_case_ms_device"] = week_ms
                cold["share_from_week_case"] = week_ms / (busy - seen
                                                          + week_ms)
            log(f"fused {QUERIES[0]} cold under the profiler: {cold}")
            out["gather_host"] = gather_host_ms(tsdb)
            out["api_queries"] = http_json(daemon.port,
                                           "/api/queries")["fused"]
            if out["api_queries"]["served"] < 10 \
                    or out["api_queries"]["devcache"]["miss"] < 1:
                fail(f"/api/queries fused: {out['api_queries']}")

            # A put of another metric into a covered hour: dirty, raw,
            # the same answer.
            expr = QUERIES[0]
            d0 = decline_count("dirty")
            said = telnet(daemon.port, [
                f"put bench.dirty {BASE + 3600 + 17} 1.5 host=h00000"])
            if "put:" in said:
                fail(f"the dirty put answered {said!r}")
            _, dirty_answer, _ = http_fused(daemon.port, expr, start, end,
                                            plan="raw")
            if decline_count("dirty") != d0 + 1:
                fail("the dirty query did not count a dirty decline")
            out["dirty"] = {"query": expr, "declined": "dirty",
                            "max_rel_diff": same_answer(
                                expr, dirty_answer, answers[expr], False)}
            out["checkpoint_2"] = timed_checkpoint(
                tsdb, "compressed checkpoint 2")
            t0 = time.perf_counter()
            daemon.stop()
            out["shutdown_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            tsdb = open_compressed_tsdb(wal)
            out["boot_s"] = time.perf_counter() - t0
            daemon = Daemon(tsdb)
            zero_decode_launches()
            runs, after = fused_queries(daemon, start, end, 0)
            out["launches_after_restart"] = dict(zip(FUSED_KERNELS,
                                                     decode_launches()))
            if out["launches_after_restart"]["block_decode"] == 0:
                fail("the fused path after the restart decoded nothing")
            same = {}
            for expr in QUERIES + PCT_QUERIES:
                exact = expr.startswith(("max", "p"))
                same[expr] = {
                    "ms": runs[expr]["first_ms"],
                    "identical": after[expr] == answers[expr],
                    "max_rel_diff": same_answer(expr, after[expr],
                                                answers[expr], exact)}
            out["after_restart"] = same
            t0 = time.perf_counter()
            rep = run_fsck(tsdb)
            out["fsck"] = {"rows": rep.rows, "errors": rep.errors,
                           "blocks": rep.blocks,
                           "codec_errors": rep.codec_errors,
                           "codec_counts": rep.codec_counts,
                           "format_counts": rep.format_counts,
                           "seconds": time.perf_counter() - t0}
            if rep.errors or rep.codec_errors or not rep.blocks \
                    or set(rep.format_counts) != {4}:
                fail(f"fsck of the v4 store: {out['fsck']}")
            log(f"fsck of the v4 store: {out['fsck']}")
        finally:
            daemon.stop()
    return out


def compare_reference(daemon: "Daemon", tsdb: TSDB, start: int,
                      end: int, union: list) -> dict:
    """The ten resident queries (each once: its stage built) and the
    un-downsampled ``union`` queries on this daemon, each against the
    one-shard daemon's answer; launches counted per path."""
    dw, ex = tsdb.devwindow, daemon.server.executor
    out: dict = {"resident": {}, "union": {}, "launches": {}}
    zero_launches()
    for expr in QUERIES + PCT_QUERIES:
        run, got = http_resident(daemon.port, dw, ex, expr, start, end)
        want = REFERENCE["resident"][expr]
        exact = expr.startswith(("max", "p"))
        out["resident"][expr] = {
            "ms": run["wall_ms"], "identical": got == want,
            "max_rel_diff": same_answer(expr, got, want, exact)}
    out["launches"]["resident"] = path_launches("sharded resident path",
                                                KERNELS[:3])
    zero_launches()
    for expr, span in union:
        skipped0 = tsdb.store.bloom_shards_skipped
        got, run, _ = http_union(daemon.port, expr, start, start + span - 1)
        want = REFERENCE["union"][expr]
        exact = Aggregators.get(spec_of(expr).aggregator).kind \
            == "percentile"
        # "identical": the same JSON, the "cached" flag included.
        out["union"][expr] = {
            "ms": run["wall_ms"], "identical": got == want,
            "max_rel_diff": same_answer(expr, got, want, exact),
            "shards_skipped": tsdb.store.bloom_shards_skipped - skipped0}
    need = {"masked_select" if Aggregators.get(spec_of(expr).aggregator)
            .kind == "percentile" else "interp_moments" for expr, _ in union}
    out["launches"]["union"] = path_launches("sharded union path",
                                             tuple(sorted(need)))
    log(f"sharded answers against the one-shard daemon's: "
        f"{json.dumps(out)}")
    return out


def budget_phase() -> dict:
    """A DeviceWindow filled to the default budget, folded on the card
    and on the CPU, then pushed past it."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(5)
    step = SPAN // BUDGET_POINTS
    t0 = time.perf_counter()
    ts = (BASE + np.arange(BUDGET_POINTS, dtype=np.int64) * step
          + rng.integers(0, step // 2, (BUDGET_SERIES, BUDGET_POINTS)))
    vals = (100 + np.cumsum(rng.standard_normal(
        (BUDGET_SERIES, BUDGET_POINTS), dtype=np.float32), axis=1))
    gen_s = time.perf_counter() - t0
    muid = b"\x00\x00\x09"

    def skey(s):
        return muid + b"\x00\x00\x01" + s.to_bytes(3, "big")

    budget = BUDGET_SERIES * BUDGET_POINTS
    dw = DeviceWindow(staging_points=STAGING, max_points=budget,
                      device=dev)
    t0 = time.perf_counter()
    for s in range(BUDGET_SERIES):
        dw.append(muid, skey(s), ts[s], vals[s])
    dw.flush()
    fill_s = time.perf_counter() - t0
    if dw._total_points != budget or dw.evicted_points:
        fail(f"budget fill: {dw._total_points} resident, "
             f"{dw.evicted_points} evicted")
    start, end = BASE, BASE + SPAN - 1
    cols = dw.chunk_columns(muid, start, end)
    resident_bytes = sum(t.numel() * t.element_size()
                         for c in cols.chunks for t in c)
    cpu_chunks = [tuple(t.cpu() for t in c) for c in cols.chunks]
    S, B = BUDGET_SERIES, _pad_size(SPAN // INTERVAL + 1)
    nseg = S * B + 1
    out = {"points": budget, "series": S, "chunks": len(cols.chunks),
           "resident_bytes": resident_bytes, "gen_s": gen_s,
           "fill_s": fill_s, "fill_points_per_s": budget / fill_s,
           "queries": {}}
    include = torch.ones(S, dtype=torch.bool, device=dev)
    gmap = torch.zeros(S, dtype=torch.int32, device=dev)
    for name, dsagg, agg_group in (("sum:1h-avg", "avg", "sum"),
                                   ("max:1h-max", "max", "max")):
        kw = dict(num_series=S, num_buckets=B, interval=INTERVAL)
        need = wk._needs(dsagg)
        qbase = start - start % INTERVAL
        args = (start - cols.epoch, end - cols.epoch, qbase - cols.epoch)

        def stage(chunks=cols.chunks, dsagg=dsagg):
            return wk.window_series_stage_chunks(chunks, *args,
                                                 agg_down=dsagg, **kw)

        grids = stage()

        def apply(grids=grids, agg_group=agg_group):
            return wk.window_moment_apply(
                *grids[:4], include, gmap, num_groups=1,
                agg_group=agg_group)

        stage_ms = median_ms(stage, reps=5)
        apply_ms = median_ms(apply, reps=5)
        # Each resident byte read once, each accumulator the stage keeps
        # (count + sum, or count + max) written once.
        acc_bytes = nseg * 4 * (1 + len(need))
        b_ms, b_by = bound_ms(resident_bytes + acc_bytes, 0)
        # The same functions on CPU tensors (the plain versions).
        got_acc = wk._fold_chunks(cols.chunks, *args, need=need, **kw)
        want_acc = wk._fold_chunks(cpu_chunks, *args, need=need, **kw)
        want = stage(cpu_chunks)
        cpu_include, cpu_gmap = include.cpu(), gmap.cpu()
        wv, wm = wk.window_moment_apply(*want[:4], cpu_include, cpu_gmap,
                                        num_groups=1, agg_group=agg_group)
        gv, gm = apply()
        if not torch.equal(got_acc[0].cpu(), want_acc[0]):
            fail(f"budget {name}: counts differ from the CPU's")
        if dsagg == "max":
            if not torch.equal(got_acc[4].cpu(), want_acc[4]) \
                    or not torch.equal(grids[0].cpu(), want[0]):
                fail(f"budget {name}: max not exact against the CPU")
        else:
            torch.testing.assert_close(got_acc[1].cpu(), want_acc[1],
                                       rtol=1e-5, atol=1e-3)
            torch.testing.assert_close(grids[0].cpu(), want[0], rtol=1e-5,
                                       atol=1e-5)
        for g, w, what in ((grids[1], want[1], "series mask"),
                           (grids[3], want[3], "in_range"),
                           (grids[4], want[4], "presence"),
                           (gm, wm, "group mask")):
            if not torch.equal(g.cpu(), w):
                fail(f"budget {name}: {what} differs from the CPU's")
        torch.testing.assert_close(grids[2].cpu(), want[2], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(gv.cpu(), wv, rtol=1e-5, atol=1e-3)
        if not bool(torch.isfinite(gv[gm]).all()) or not bool(gm.any()):
            fail(f"budget {name}: empty or non-finite answer")
        out["queries"][name] = {
            "stage_ms": stage_ms, "apply_ms": apply_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / stage_ms}
        log(f"budget {name}: stage {stage_ms:.3f} ms (bound {b_ms:.4f} "
            f"ms by {b_by}, {len(cols.chunks)} chunks), apply "
            f"{apply_ms:.3f} ms")
        del grids, got_acc, want_acc, want

    # One more staging batch, later in time: the oldest chunk goes.
    mw = dw._metrics[muid]
    oldest_max = mw.chunks[0]["max_ts"]
    per = STAGING // BUDGET_POINTS
    later = BASE + SPAN + np.arange(BUDGET_POINTS, dtype=np.int64) * step
    for s in range(per):
        dw.append(muid, skey(s), later, np.ones(BUDGET_POINTS, np.float32))
    dw.flush()
    if dw.evicted_points != STAGING:
        fail(f"budget eviction: {dw.evicted_points} points evicted")
    if mw.complete_from != oldest_max + 1:
        fail(f"budget eviction: complete_from {mw.complete_from}, "
             f"wanted {oldest_max + 1}")
    if dw.chunk_columns(muid, start, int(later[-1])) is not None:
        fail("budget eviction: a query before complete_from was served")
    kept = dw.chunk_columns(muid, mw.complete_from, int(later[-1]))
    if kept is None or len(kept.chunks) != len(cols.chunks):
        fail("budget eviction: the kept window does not serve")
    out["eviction"] = {"evicted_points": dw.evicted_points,
                       "complete_from": mw.complete_from,
                       "chunks_after": len(kept.chunks)}
    log(f"budget eviction: {out['eviction']}")
    del dw, cols, kept, cpu_chunks
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Sketch kernels (csrc/sketches.cu)
# ---------------------------------------------------------------------------

SKETCH_KERNELS = ("tdigest_fold", "hll_fold", "hll_estimate",
                  "merged_quantile")


def sketch_launches() -> dict:
    return {k: getattr(sketches, k).launches for k in SKETCH_KERNELS}


def zero_sketch_launches() -> None:
    for k in SKETCH_KERNELS:
        getattr(sketches, k).launches = 0


def corpus_tag_uids() -> tuple[np.ndarray, np.ndarray]:
    """The tag-value UIDs the daemon gives the corpus' hosts and dcs:
    UniqueId assigns them in first-use order, host before dc within a
    series (series s < 10 brings a new dc)."""
    s = np.arange(SERIES)
    host = np.where(s < 10, 2 * s + 1, s + 11).astype(np.int32)
    dc = (2 * np.arange(10) + 2).astype(np.int32)
    return host, dc


def sort_bound(nbytes: float, live: torch.Tensor) -> tuple:
    """Bound of a compress that sorts ``live`` entries a row (one count a
    row): the bytes it must move against n log2 n comparisons plus ~20
    float operations (the cluster formula) per live entry, whichever is
    larger. Counts what this run's data needs, whatever the kernel's
    design."""
    n = live.to(torch.float64)
    ops = float((n * torch.log2(n.clamp(min=1)) + 20 * n).sum())
    return bound_ms(nbytes, ops)


def fold_bound(idx, valid, m0, w0) -> tuple:
    """Bytes: each folded row's centroids read and written (8 B each way),
    the batch and its mask read once; operations: sort_bound's, over each
    row's entries of nonzero weight (old centroids and valid values)."""
    keep = idx < m0.shape[0]
    rows = idx[keep].long()
    K, P = m0.shape[1], valid.shape[1]
    live = (w0[rows] != 0).sum(1) + valid[keep].sum(1)
    return sort_bound(len(rows) * (K * 16 + P * 5 + 4), live)


def fold_sort_keys(idx, batch, valid, m0, w0) -> torch.Tensor:
    """The composite keys of each folded row's K + P entries: the fold's
    library yardstick sorts them along dim 1 (its sort alone)."""
    keep = idx < m0.shape[0]
    rows = idx[keep].long()
    m = torch.cat([m0[rows], batch[keep]], 1)
    w = torch.cat([w0[rows], valid[keep].to(torch.float32)], 1)
    return sketches._sort_keys(
        torch.where(w > 0, m, torch.full_like(m, float("inf"))))


def host_us(fn, reps: int = 1000) -> float:
    """Mean host time of one call of ``fn`` in microseconds, over ``reps``
    calls after a warm-up, the card drained before and after (what a
    call launches runs faster than the host issues it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def launch_floor(flush, regs, fold_args, fold_regs, library) -> dict:
    """The card's launch floor: an empty kernel launched the way the
    sketch wrappers launch theirs (``sketches.empty_launch``), timed as
    the kernels are (``ms``, ``ms_cold``, ``ms_device``); and the host's
    time in each step of a wrapper call, beside whole calls of the HLL
    wrappers (a hand-off's fold, the estimate over ``regs``) and of the
    fold's ``scatter_reduce_`` yardstick."""
    dev = regs.get_device()
    device = regs.device
    lib = sketches._kernels()
    stream = torch._C._cuda_getCurrentRawStream(dev)

    def empty():
        sketches.empty_launch(dev)

    def guarded():  # the guard entered around every launch
        with torch.cuda.device(device):
            lib.empty_launch(torch._C._cuda_getCurrentRawStream(dev))

    def enter_exit():
        with torch.cuda.device(device):
            pass

    # Every check runs; the plain fold of no items returns at once.
    empty_fold = (torch.zeros((8, 1 << 12), dtype=torch.int32),
                  torch.zeros(0, dtype=torch.int32),
                  torch.zeros((0, 2048), dtype=torch.int32),
                  torch.zeros((0, 2048), dtype=torch.bool))

    steps = {
        "tensor.device": lambda: regs.device,
        "tensor.get_device()": regs.get_device,
        "torch.cuda.device enter + exit": enter_exit,
        "torch._C._cuda_getDevice": torch._C._cuda_getDevice,
        "torch._C._cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(dev),
        "contiguous() of a contiguous tensor": regs.contiguous,
        "data_ptr()": regs.data_ptr,
        "torch.empty(8) on the card":
            lambda: torch.empty(8, device=device),
        "ctypes call of the empty kernel": lambda: lib.empty_launch(stream),
        "empty_launch (the wrappers' launch path)": empty,
        "empty launch under torch.cuda.device": guarded,
        "hll_fold's checks (a call on empty CPU tensors)":
            lambda: sketches.hll_fold(*empty_fold, p=12),
        "hll_fold, one hand-off": lambda: sketches.hll_fold(
            fold_regs, *fold_args, p=12),
        "hll_estimate, the p = 12 stack": lambda: sketches.hll_estimate(regs),
        "scatter_reduce_ yardstick, one hand-off": library}
    res = {"name": "launch_floor", "stage": "empty kernel",
           "ms": median_ms(empty), "ms_cold": median_ms(empty, flush=flush),
           "ms_device": device_ms(empty),
           "host_us": {k: host_us(f) for k, f in steps.items()}}
    log(f"launch floor: {res['ms']:.4f} ms, cold {res['ms_cold']:.4f}, "
        f"device {res['ms_device']:.4f}; host us {res['host_us']}")
    return res


def sketch_kernel_phase(vals: np.ndarray) -> list:
    """Each sketch kernel against its plain version on the card, at the
    shapes the daemon gives it:
    - tdigest_fold: one hand-off of Config.sketch_flush_points from the
      corpus (the first 1,049 series' 1,000 values, P = 1024, in a
      2048-row call, empty digests: every series is new), and the
      4096-value chunk (1024 digests of 1,000 values each, with 4096 more
      values a row);
    - hll_fold: one hand-off's host and dc UIDs (the first 1,049 series'
      hosts, their 10 dcs) into the (metric, host) and (metric, dc)
      registers at p = 12 (8 x 2,048 items, 6 rows padded); all the
      corpus' hosts and dcs at once (8 x 16,384); and the UIDs of dc0's
      1,000 corpus hosts into one row at p = 14 (distinct_tagv);
    - hll_estimate: over the p = 12 stack holding every host and dc;
    - merged_quantile: p50/p95/p99 over all 10,000 corpus digests (S =
      16,384 rows of which 10,000 valid, 2,097,152 entries).
    Each is timed like the other kernels; the library yardstick is one
    scatter_reduce_ (amax) over precomputed ranks for the HLL fold, and
    for the t-digest fold and the merged quantile one torch.sort of their
    composite keys (their sort alone: each row's along dim 1 for the
    fold); the estimate has no single PyTorch call."""
    dev = torch.device(DEVICE)
    K = Config.sketch_compression
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    results = []

    def case(name, stage, fn, plain, library, check, bound):
        check()
        res = {"name": name, "stage": stage, **check.result,
               "bound_ms": bound[0], "bound_by": bound[1]}
        return time_case(res, fn, plain, library, flush)

    # Fold at the path's shape: one hand-off (the daemon's stack then holds
    # _pad(first) rows, and the call pads its rows the same way).
    first = min(-(-Config.sketch_flush_points // POINTS), SERIES)
    rows, P = _sk_pad(first), _sk_pad(POINTS)
    stack_m = torch.zeros((rows, K), device=dev)
    stack_w = torch.zeros((rows, K), device=dev)
    batch = np.zeros((rows, P), np.float32)
    batch[:first, :POINTS] = vals[:first]
    valid = np.zeros((rows, P), bool)
    valid[:first, :POINTS] = True
    idx = np.full(rows, rows, np.int32)
    idx[:first] = np.arange(first)
    fold_args = [torch.from_numpy(a).to(dev) for a in (idx, batch, valid)]

    def fold_check(args=fold_args, m0=stack_m, w0=stack_w, P=P):
        m1, w1, m2, w2 = m0.clone(), w0.clone(), m0.clone(), w0.clone()
        sketches.tdigest_fold(m1, w1, args[0], args[1], valid=args[2],
                              compression=K)
        sketches.tdigest_fold_plain(m2, w2, args[0], args[1], args[2],
                                    compression=K)
        torch.cuda.synchronize()
        # Weights: integral float32 sums, exact. Means: the plain
        # version's scatter_add adds in atomic order: rtol 1e-5.
        if not torch.equal(w1, w2):
            fail(f"tdigest_fold P={P}: cluster weights differ")
        torch.testing.assert_close(m1, m2, rtol=1e-5, atol=1e-6)
        fold_check.result = {"rows": int((args[0] < m0.shape[0]).sum()),
                             "K": K, "P": P,
                             "max_abs_err": float((m1 - m2).abs().max())}
        return m1, w1

    def mk_fold(args, m0, w0, plain=False):
        m, w = m0.clone(), w0.clone()
        f = sketches.tdigest_fold_plain if plain else sketches.tdigest_fold

        def run():
            if plain:
                f(m, w, args[0], args[1], args[2], compression=K)
            else:
                f(m, w, args[0], args[1], valid=args[2], compression=K)
        return run

    keys1 = fold_sort_keys(*fold_args, stack_m, stack_w)
    results.append(case(
        "tdigest_fold", "one hand-off (1,049 series x 1,000 values)",
        mk_fold(fold_args, stack_m, stack_w),
        mk_fold(fold_args, stack_m, stack_w, plain=True),
        lambda: torch.sort(keys1, dim=1), fold_check,
        fold_bound(fold_args[0], fold_args[2], stack_m, stack_w)))
    folded_m, folded_w = fold_check(fold_args, stack_m, stack_w, P)

    # Fold at the 4096-value chunk, into digests of 1,000 values.
    P4 = LiveSketches._MAX_CHUNK
    rows4 = min(LiveSketches._MAX_FOLD_CELLS // P4, first,
                vals.size // P4)
    m0, w0 = folded_m[:rows4].contiguous(), folded_w[:rows4].contiguous()
    chunk = vals.reshape(-1)[:rows4 * P4].reshape(rows4, P4)
    args4 = [torch.arange(rows4, dtype=torch.int32, device=dev),
             torch.from_numpy(np.ascontiguousarray(chunk)).to(dev),
             torch.ones((rows4, P4), dtype=torch.bool, device=dev)]

    def fold4_check():
        fold_check(args4, m0, w0, P4)
        fold4_check.result = fold_check.result

    keys4 = fold_sort_keys(*args4, m0, w0)
    results.append(case(
        "tdigest_fold", "4096-value chunk (1,024 rows)",
        mk_fold(args4, m0, w0), mk_fold(args4, m0, w0, plain=True),
        lambda: torch.sort(keys4, dim=1), fold4_check,
        fold_bound(args4[0], args4[2], m0, w0)))

    # HLL folds: one hand-off's host and dc rows at p = 12 (the first
    # `first` series' hosts and their dcs, padded as _fold_buffers pads
    # them); every corpus host and dc at p = 12 (the stack's state once
    # all is folded, which the estimate reads); dc0's hosts at p = 14.
    host, dc = corpus_tag_uids()
    hll_cases = []

    def hll_rows(uid_rows, C, slots=None):
        H, U = _sk_pad(len(uid_rows)), _sk_pad(max(map(len, uid_rows)))
        items = np.zeros((H, U), np.int32)
        valid = np.zeros((H, U), bool)
        for i, u in enumerate(uid_rows):
            items[i, :len(u)] = u
            valid[i, :len(u)] = True
        idx = np.full(H, C, np.int32)
        idx[:len(uid_rows)] = (np.arange(len(uid_rows)) if slots is None
                               else slots)
        return idx, items, valid

    hand_off = [host[:first], np.unique(dc[np.arange(first) % 10])]
    hll_cases.append(("one hand-off: host + dc, p = 12", 12, _sk_pad(2),
                      *hll_rows(hand_off, _sk_pad(2)), None))
    hll_cases.append(("all hosts + dcs, p = 12", 12, _sk_pad(2),
                      *hll_rows([host, dc], _sk_pad(2)), None))
    dc0 = host[::10]
    items14 = np.zeros((1, _pad_size(len(dc0))), np.int32)
    items14[0, :len(dc0)] = dc0
    valid14 = np.zeros(items14.shape, bool)
    valid14[0, :len(dc0)] = True
    hll_cases.append(("dc0's hosts, p = 14 (distinct_tagv)", 14, 1,
                      np.zeros(1, np.int32), items14, valid14, None))
    # The hand-off's hosts in four rows that all name slot 0 (the max over
    # every row that names a slot), its dcs in slot 1.
    quarter = -(-first // 4)
    hll_cases.append(("one hand-off, the hosts in 4 rows on one slot",
                      12, _sk_pad(2), *hll_rows(
                          [host[i:min(i + quarter, first)]
                           for i in range(0, first, quarter)]
                          + [hand_off[1]], _sk_pad(2), [0, 0, 0, 0, 1]),
                      None))
    regs12 = None
    for stage, p, C, idx_h, items_h, valid_h, start in hll_cases:
        a = [torch.from_numpy(x).to(dev) for x in (idx_h, items_h, valid_h)]
        regs0 = (torch.zeros((C, 1 << p), dtype=torch.int32, device=dev)
                 if start is None else start)
        n_items = int(valid_h.sum())

        def hll_check(a=a, regs0=regs0, p=p, n_items=n_items):
            r1, r2 = regs0.clone(), regs0.clone()
            sketches.hll_fold(r1, *a, p=p)
            sketches.hll_fold_plain(r2, *a, p=p)
            torch.cuda.synchronize()
            if not torch.equal(r1, r2):
                fail(f"hll_fold p={p}: registers differ")
            hll_check.result = {"p": p, "rows": list(a[1].shape),
                                "items": n_items, "max_abs_err": 0.0}
            hll_check.regs = r1

        keep = a[0] < C
        reg_idx, rank = sketches._hll_ranks(a[1][keep], a[2][keep], p)
        tgt = torch.zeros((int(keep.sum()), (1 << p) + 1),
                          dtype=torch.int32, device=dev)

        def library(tgt=tgt, reg_idx=reg_idx, rank=rank):
            return tgt.scatter_reduce_(1, reg_idx, rank, "amax")

        # Each timed call folds into a stack of its own, as it stood before
        # the case (the kernel skips the atomic of a rank that raises
        # nothing, so a call into a stack it raised already would time the
        # re-fold instead): 63 calls in time_case.
        stacks = itertools.cycle([regs0.clone() for _ in range(64)])

        def fn(a=a, stacks=stacks, p=p):
            sketches.hll_fold(next(stacks), *a, p=p)

        def plain(a=a, r=regs0.clone(), p=p):
            sketches.hll_fold_plain(r, *a, p=p)
        # Bytes: every mask byte of the folded rows and each valid item
        # read once, each register the items name read once and each one
        # they raise written once (padded rows return at once).
        rows_used = int(keep.sum().item())
        live = reg_idx < (1 << p)
        slots = a[0][keep].long()[:, None].expand_as(reg_idx)
        touched = int(torch.unique(slots[live] * (1 << p)
                                   + reg_idx[live]).numel())
        after = regs0.clone()
        sketches.hll_fold_plain(after, *a, p=p)
        raised = int((after != regs0).sum())
        results.append(case(
            "hll_fold", stage, fn, plain, library, hll_check,
            bound_ms(rows_used * items_h.shape[1] + 4 * n_items
                     + 4 * touched + 4 * raised, 10 * n_items)))
        results[-1].update(touched=touched, raised=raised)
        if stage.startswith("one hand-off:"):
            handoff = (a, hll_check.regs, library)
        if stage.startswith("all hosts"):
            regs12 = hll_check.regs
            # Steady state: every host and dc folded again into the stack
            # they raised (each hand-off of a running daemon re-folds the
            # tag values it saw since the last one).
            hll_cases.append(("every host and dc again into the stack "
                              "they raised, p = 12", 12, C, idx_h, items_h,
                              valid_h, regs12))

    # Estimate over the p = 12 stack.
    def est_check(regs=regs12):
        got = sketches.hll_estimate(regs)
        want = sketches.hll_estimate_plain(regs)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        if not torch.equal(torch.round(got), torch.round(want)):
            fail("hll_estimate: rounded estimates differ")
        est_check.result = {"rows": regs.shape[0],
                            "estimates": got[:2].tolist(),
                            "max_abs_err": float((got - want).abs().max())}

    results.append(case(
        "hll_estimate", "over the p = 12 stack (8 x 4096)",
        lambda: sketches.hll_estimate(regs12),
        lambda: sketches.hll_estimate_plain(regs12), None, est_check,
        bound_ms(regs12.numel() * 4 + regs12.shape[0] * 4,
                 3 * regs12.numel())))

    results.append(launch_floor(flush, regs12, *handoff))

    # Merged quantile over all corpus digests.
    S = _sk_pad(SERIES)
    mq_m = torch.zeros((S, K), device=dev)
    mq_w = torch.zeros((S, K), device=dev)
    per = LiveSketches._MAX_FOLD_CELLS // P
    for lo in range(0, SERIES, per):
        hi = min(lo + per, SERIES)
        b = torch.zeros((per, P), device=dev)
        b[:hi - lo, :POINTS] = torch.from_numpy(vals[lo:hi]).to(dev)
        v = torch.zeros((per, P), dtype=torch.bool, device=dev)
        v[:hi - lo, :POINTS] = True
        ids = torch.full((per,), S, dtype=torch.int32, device=dev)
        ids[:hi - lo] = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        sketches.tdigest_fold(mq_m, mq_w, ids, b, valid=v, compression=K)
    mq_idx = torch.arange(S, dtype=torch.int32, device=dev)
    mq_valid = mq_idx < SERIES
    qs = torch.tensor(SKETCH_QS, dtype=torch.float32, device=dev)

    def mq_check():
        got = sketches.merged_quantile(mq_m, mq_w, mq_idx, mq_valid, qs,
                                       compression=K)
        again = sketches.merged_quantile(mq_m, mq_w, mq_idx, mq_valid, qs,
                                         compression=K)
        want = sketches.merged_quantile_plain(mq_m, mq_w, mq_idx, mq_valid,
                                              qs, compression=K)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail("merged_quantile: two runs on one state differ")
        # A cluster's mean sums up to ~2e4 centroids in float32, in
        # another order than the plain version's atomics: ~sqrt(n) eps of
        # the sum, so rtol 1e-4.
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        exact = np.quantile(vals.astype(np.float64), SKETCH_QS)
        mq_check.result = {
            "S": S, "K": K, "entries": S * K, "quantiles": got.tolist(),
            "exact": exact.tolist(),
            "max_abs_err": float((got - want).abs().max())}

    keyf = torch.where(mq_w > 0, mq_m, torch.full_like(mq_m, float("inf")))
    comp = sketches._sort_keys(keyf.reshape(-1))
    # Bytes: only the valid rows' centroids are read, with the selection
    # and the quantiles; operations: sort_bound's over the entries of
    # nonzero weight.
    mq_live = (mq_w[mq_idx[mq_valid].long()] != 0).sum().reshape(1)
    results.append(case(
        "merged_quantile", "all series, S = 16,384 (2,097,152 entries)",
        lambda: sketches.merged_quantile(mq_m, mq_w, mq_idx, mq_valid, qs,
                                         compression=K),
        lambda: sketches.merged_quantile_plain(mq_m, mq_w, mq_idx,
                                               mq_valid, qs, compression=K),
        lambda: torch.sort(comp), mq_check,
        sort_bound(SERIES * K * 8 + S * 5 + 3 * 8, mq_live)))
    results[-1]["live_entries"] = int(mq_live)
    del stack_m, stack_w, folded_m, folded_w, mq_m, mq_w, comp, flush
    del keys1, keys4
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Sketch path: /sketch and /distinct on the daemon
# ---------------------------------------------------------------------------

def sketch_targets(start: int, end: int) -> list:
    """The smoke's /sketch and /distinct requests: all-time quantiles over
    every series, {dc=dc0} and {host=h00001}; streaming distinct hosts and
    dcs; one ranged /sketch and one ranged /distinct over {dc=dc0}."""
    q = "p50,p95,p99"
    return [
        ("all", "/sketch?" + urllib.parse.urlencode(
            {"m": "bench.metric", "q": q})),
        ("dc0", "/sketch?" + urllib.parse.urlencode(
            {"m": "bench.metric{dc=dc0}", "q": q})),
        ("h00001", "/sketch?" + urllib.parse.urlencode(
            {"m": "bench.metric{host=h00001}", "q": q})),
        ("distinct host", "/distinct?metric=bench.metric&tagk=host"),
        ("distinct dc", "/distinct?metric=bench.metric&tagk=dc"),
        ("ranged dc0", "/sketch?" + urllib.parse.urlencode(
            {"m": "bench.metric{dc=dc0}", "q": q, "start": start,
             "end": end})),
        ("ranged distinct dc0", "/distinct?" + urllib.parse.urlencode(
            {"metric": "bench.metric", "tagk": "host", "tags": "dc=dc0",
             "start": start, "end": end})),
    ]


def sketch_answers(port: int, start: int, end: int) -> dict:
    out = {}
    for name, target in sketch_targets(start, end):
        q0 = time.perf_counter()
        status, body = http_get(port, target)
        wall = (time.perf_counter() - q0) * 1e3
        if status != 200:
            fail(f"{target}: HTTP {status}: {body[:300]!r}")
        out[name] = {"wall_ms": wall, "body": body}
    return out


def rank_error(sorted_vals: np.ndarray, value: float, q: float) -> float:
    """How far q lies outside [share of the exact values below ``value``,
    share at or below it]: 0 when ``value`` sits at quantile q."""
    n = len(sorted_vals)
    a = np.searchsorted(sorted_vals, np.float32(value), side="left") / n
    b = np.searchsorted(sorted_vals, np.float32(value), side="right") / n
    return 0.0 if a <= q <= b else float(min(abs(a - q), abs(b - q)))


def sketch_path(tsdb: TSDB, port: int, vals: np.ndarray, telnet: list,
                start: int, end: int) -> dict:
    """The sketch routes on the daemon after ingest, each answer held
    against the corpus: quantiles within SKETCH_RANK_TOL in rank of the
    exact float32 values of the selected series, the ranged /sketch
    equal to their exact quantiles, distinct counts within hll_error of
    the truth (10,020 hosts, 10 dcs; 1,002 hosts in dc0)."""
    answers = sketch_answers(port, start, end)
    host_of = {f"h{s:05d}": s for s in range(SERIES)}
    t_vals = np.array([v for _, _, v in telnet], np.float32)
    t_dc0 = np.array([v for _, d, v in telnet if d == "dc0"], np.float32)
    pools = {"all": np.concatenate([vals.reshape(-1), t_vals]),
             "dc0": np.concatenate([vals[::10].reshape(-1), t_dc0]),
             "h00001": vals[host_of["h00001"]]}
    series = {"all": SERIES + TELNET_SERIES, "dc0": SERIES // 10 + 2,
              "h00001": 1}
    out = {}
    for name, pool in pools.items():
        a = json.loads(answers[name]["body"])
        srt = np.sort(pool)
        errs = {qk: rank_error(srt, v, float(qk))
                for qk, v in a["quantiles"].items()}
        if a["series"] != series[name]:
            fail(f"/sketch {name}: {a['series']} series, want "
                 f"{series[name]}")
        if max(errs.values()) > SKETCH_RANK_TOL:
            fail(f"/sketch {name}: rank errors {errs} beyond "
                 f"{SKETCH_RANK_TOL}")
        out[name] = {"wall_ms": answers[name]["wall_ms"],
                     "quantiles": a["quantiles"], "rank_err": errs}
        if name == "dc0":
            r = json.loads(answers["ranged dc0"]["body"])
            exact = np.quantile(pool.astype(np.float64), SKETCH_QS)
            if r.get("rollup") != "raw" or list(r["quantiles"].values()) \
                    != exact.tolist():
                fail(f"ranged /sketch dc0: {r} vs exact {exact.tolist()}")
            out["ranged dc0"] = {"wall_ms": answers["ranged dc0"]["wall_ms"],
                                 "rollup": r["rollup"],
                                 "quantiles": r["quantiles"]}
    for name, truth, p in (("distinct host", SERIES + TELNET_SERIES, 12),
                           ("distinct dc", 10, 12),
                           ("ranged distinct dc0", SERIES // 10 + 2, 14)):
        a = json.loads(answers[name]["body"])
        n = a["distinct"]
        bound = hll_error(p, n)
        if abs(n - truth) > bound:
            fail(f"/distinct {name}: {n}, truth {truth}, bound {bound}")
        out[name] = {"wall_ms": answers[name]["wall_ms"], "distinct": n,
                     "truth": truth, "hll_error": bound,
                     "source": a["source"]}
    log(f"sketch routes: {out}")
    return out


def _catch(fn, errs: list) -> None:
    try:
        fn()
    except BaseException as e:  # re-raised by the caller
        errs.append(e)


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this smoke "
            "runs only on an NVIDIA card")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    # The native ingest extension and telnet decoder (gcc / g++) build
    # beside the kernels (nvcc).
    native_err: list = []
    native = threading.Thread(target=lambda: _catch(nativeext.build_all,
                                                    native_err))
    native.start()
    cuda_build.build_all()
    native.join()
    if native_err:
        raise native_err[0]
    build_s = time.perf_counter() - t0
    log(f"built {cuda_build.sources()} and the native libraries in "
        f"{build_s:.1f} s (native: {nativeext.build_seconds})")

    ts, vals = corpus()
    kernels = (kernel_phase(ts, vals) + select_interp_phase(ts, vals)
               + sketch_kernel_phase(vals))
    with tempfile.TemporaryDirectory() as wal_dir:
        path = path_phase(ts, vals, wal_dir)
    compressed = compressed_phase(ts, vals, path)
    kernels += compressed["kernel_cases"]
    sharded = sharded_phase(ts, vals)
    REFERENCE.clear()
    sharded["writer_pause"] = writer_pause_phase(ts, vals)
    del ts, vals
    refusal = refusal_phase()
    budget = budget_phase()

    # Each path's launches beside the times at that path's shape; the
    # first path listed gives a kernel's top-level numbers.
    fold = {"resident": "window chunk fold", "scan": "series stage"}
    shapes = {
        "segment_sum": fold, "segment_minmax": fold,
        "masked_select": {"resident": "window select, columns",
                          "union": "union p95 {dc=dc0} one day"},
        "interp_moments": {"union": "union {dc=dc0} one day"},
        "tdigest_fold": {
            "sketch": "one hand-off (1,049 series x 1,000 values)"},
        "hll_fold": {"sketch": "one hand-off: host + dc, p = 12"},
        "hll_estimate": {"sketch": "over the p = 12 stack (8 x 4096)"},
        "merged_quantile": {
            "sketch": "all series, S = 16,384 (2,097,152 entries)"},
        "block_decode": {"fused": "week gather (TSF32)"}}
    where = {
        "segment_sum": ("segment_reduce.cu",
                        "opentsdb_tpu/ops/pallas_kernels.py:77"),
        "segment_minmax": ("segment_reduce.cu",
                           "opentsdb_tpu/ops/kernels.py:95"),
        "masked_select": ("masked_select.cu",
                          "opentsdb_tpu/ops/kernels.py:818"),
        "interp_moments": ("interp_moments.cu",
                           "opentsdb_tpu/ops/kernels.py:1100"),
        "tdigest_fold": ("sketches.cu",
                         "opentsdb_tpu/stats/livesketch.py:436"),
        "hll_fold": ("sketches.cu", "opentsdb_tpu/stats/livesketch.py:451"),
        "hll_estimate": ("sketches.cu", "opentsdb_tpu/ops/sketches.py:196"),
        "merged_quantile": ("sketches.cu",
                            "opentsdb_tpu/stats/livesketch.py:460"),
        "block_decode": ("block_decode.cu",
                         "opentsdb_tpu/compress/kernels.py:72")}
    numbers = ("max_abs_err", "ms", "ms_cold", "ms_device", "plain_ms",
               "bound_ms", "bound_by", "library_ms")
    by_case = {(r["name"], r["stage"]): r for r in kernels}
    path_launches_of = dict(path["launches"],
                            fused=compressed["launches"])
    line = []
    for name, shape in shapes.items():
        paths = {}
        for p, stage in shape.items():
            r = by_case[(name, stage)]
            paths[p] = {"stage": stage,
                        "launches": path_launches_of[p][name],
                        **{k: r[k] for k in numbers}}
        entry = {"name": name, "route": "cuda",
                 "source": f"opentsdb_tpu_torch/csrc/{where[name][0]}",
                 "replaces": where[name][1],
                 **paths[next(iter(shape))], "paths": paths}
        if name == "interp_moments":
            r = by_case[(name, "union full width")]
            entry["full_width"] = {k: r[k] for k in numbers}
        others = [r for r in kernels if r["name"] == name
                  and r["stage"] not in shape.values()
                  and name in SKETCH_KERNELS + ("block_decode",)]
        if others:
            entry["other_cases"] = {r["stage"]: {k: r[k] for k in numbers}
                                    for r in others}
        if name == "block_decode":
            entry["library"] = NO_LIBRARY
            entry["kernels_per_call"] = by_case[(
                name, shape["fused"])]["kernels_per_call"]
        line.append(entry)
    log(json.dumps({"details": {
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "kernel_cases": kernels, "path": path,
        "compressed": compressed, "sharded": sharded, "refusal": refusal,
        "budget": budget}}))
    for expr, q in path["queries"].items():
        print(json.dumps({"query": expr, "plan": "resident", **q,
                          "card": smi}))
    for expr, run in path["union"].items():
        print(json.dumps({"query": expr, "plan": "raw", **run,
                          "check": path["checks"][expr], "card": smi}))
    print(json.dumps({"sketch": path["sketch"], "card": smi}))
    print(json.dumps({"ingest_points_per_s":
                      path["ingest"]["points_per_s"],
                      "ingest": {k: v for k, v in path["ingest"].items()},
                      "window": path["window"],
                      "launches": path["launches"],
                      "qcache_before_checkpoint": path["qcache"],
                      "card": smi}))
    for k in ("profile_warm", "profile_stage_build"):
        p = path[k]
        print(json.dumps({k: QUERIES[1], "wall_ms": p["wall_ms"],
                          "device_busy_ms": p["device_busy_ms"],
                          "device_busy_share": p["device_busy_share"],
                          "card": smi}))
    r = path["restart"]
    print(json.dumps({"tenants": {
        "http_ingest": {k: v for k, v in path["tenants"].items()
                        if k != "api_tenants"},
        "api_tenants": path["tenants"]["api_tenants"],
        "snapshot_bytes": r["checkpoint_1"]["tenant_snapshot_bytes"],
        "snapshot_save_s": r["checkpoint_1"]["tenant_save_s"],
        "snapshot_load_s": r["tenant_load_s"],
        "same_after_restart": r["tenants_same_after_restart"],
        "marker_rebuild": r["marker_rebuild"],
        "refusal": refusal,
        "gc_full_ms": r["gc_full_ms"],
        "gc_full_ms_untuned": GC_FULL_MS_UNTUNED,
        "gc_during_ingest": path["ingest"]["gc"],
        "ingest_points_per_s": path["ingest"]["points_per_s"]},
        "card": smi}))
    print(json.dumps({"restart": {
        "checkpoints": [r["checkpoint_1"], r["checkpoint_2"]],
        **{k: r[k] for k in ("shutdown_s", "boot_s", "open_generations_s",
                             "replay_s", "wal_replay", "warm_s",
                             "generations",
                             "generation_bytes", "generation_scan_ms",
                             "generation_scan_warm_ms", "gc_full_ms",
                             "bloom", "qcache", "repeats")},
        "memtable_scan_ms": path["scan_ms"],
        "queries": r["queries"], "union": r["union"],
        "sketch_save_s": r["checkpoint_1"]["sketch_save_s"],
        "sketch_load_s": r["sketch_load_s"], "sketch": r["sketch"],
        "launches": {"resident": r["launches_resident"],
                     "union": r["launches_union"],
                     "sketch": r["launches_sketch"],
                     "repeats": r["launches_repeats"]}}, "card": smi}))
    totals = {site: sum(c[site] for c in NATIVE_STAGES.values())
              for site in nativeext.SITES}
    print(json.dumps({"native": {
        "build_s": nativeext.build_seconds, "calls": totals,
        "stages": NATIVE_STAGES, "wal_replay": r["wal_replay"]},
        "card": smi}))
    a = sharded["answers"]
    print(json.dumps({"sharded": {
        "shards": SHARDS, "wal_group_ms": WAL_GROUP_MS,
        "ingest_points_per_s": sharded["ingest"]["points_per_s"],
        "add_batch_points_per_s": sharded["ingest"]["add_batch_points_per_s"],
        "telnet_points_per_s": sharded["ingest"]["telnet_points_per_s"],
        "api_put_points_per_s": sharded["tenants"]["http_points_per_s"],
        "group_flushes_per_s": sharded["group_flushes_per_s"],
        "checkpoint_1": sharded["checkpoint_1"],
        "checkpoint_2": sharded["checkpoint_2"],
        "writer_pause": sharded["writer_pause"],
        "shutdown_s": sharded["shutdown_s"], "boot_s": sharded["boot_s"],
        "warm_s": sharded["warm_s"],
        "host_week_scan_cold_ms": sharded["host_week_scan_cold_ms"],
        "bloom_shards_skipped": sharded["bloom_shards_skipped"],
        "answers_identical": {
            "before": sum(q["identical"] for k in ("resident", "union")
                          for q in a[k].values()),
            "after_restart": sum(
                q["identical"] for k in ("resident", "union")
                for q in sharded["answers_after_restart"][k].values()),
            "of": [len(QUERIES + PCT_QUERIES) + len(UNION_QUERIES),
                   len(QUERIES + PCT_QUERIES) + 1]},
        "launches": {"resident": a["launches"]["resident"],
                     "union": a["launches"]["union"]},
        "fsck": {"one_shard": r["fsck"], "sharded": sharded["fsck"]},
        "native": {k: v for k, v in NATIVE_STAGES.items()
                   if k.startswith("sharded_")}},
        "card": smi}))
    c = compressed
    print(json.dumps({"compressed": {
        "ingest": c["ingest"], "checkpoint_1": c["checkpoint_1"],
        "checkpoint_2": c["checkpoint_2"], "bytes": c["bytes"],
        "queries": c["queries"], "int_query": c["int_query"],
        "legs": c["legs"], "gather_host": c["gather_host"],
        "profile": {k: {"query": QUERIES[1], **{
            f: c[k][f] for f in ("wall_ms", "device_busy_ms",
                                 "device_busy_share")}}
            for k in ("profile_cold", "profile_warm")},
        "decode_share_cold": {"query": QUERIES[0], **{
            f: c["profile_cold_sum"].get(f, "not measured") for f in (
                "wall_ms", "device_busy_ms", "matched_ms",
                "matched_share_of_busy", "week_case_ms_device",
                "share_from_week_case")}},
        "launches": c["launches"],
        "launches_after_restart": c["launches_after_restart"],
        "api_queries": c["api_queries"], "dirty": c["dirty"],
        "shutdown_s": c["shutdown_s"], "boot_s": c["boot_s"],
        "after_restart": c["after_restart"], "fsck": c["fsck"],
        "decode": {r["stage"]: {k: r[k] for k in (
            "points", "padded_points", "payload_bytes", "ms", "ms_cold",
            "ms_device", "plain_ms", "bound_ms", "bytes",
            "kernels_per_call", "memsets_per_call")}
            for r in c["kernel_cases"]}}, "card": smi}))
    r_obs = path["obs"]
    print(json.dumps({"obs": {
        "resident": {k: v for k, v in r_obs["resident"].items()
                     if k != "trace"},
        "scan": {k: v for k, v in r_obs["scan"].items() if k != "trace"},
        "answered": r_obs["answered"],
        "metrics_samples": r_obs["metrics_samples"],
        "sharded_scan_wall_ms": sharded["traced_scan"]["wall_ms"],
        "sharded_checkpoint_split": sharded["checkpoint_split"],
        "sharded_checkpoint_stats": sharded["checkpoint_split_stats"],
        "checkpoint_phase_ms": [r["checkpoint_1"]["phase_ms"],
                                r["checkpoint_2"]["phase_ms"]],
        "timers_after_restart": r["timers"]}, "card": smi}))
    print(json.dumps({"window_at_budget": {
        k: budget[k] for k in ("points", "chunks", "resident_bytes",
                               "fill_points_per_s", "queries",
                               "eviction")}, "card": smi}))
    print(json.dumps({"launch_floor": next(
        r for r in kernels if r["name"] == "launch_floor"), "card": smi}))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
