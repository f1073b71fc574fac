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
   The rollup window fold (``csrc/rollup_fold.cu``) the same way at the
   tier's group (the first day of the rollup phase's 2,500 series at 1 h
   and 1 d: one launch, the device-folded checkpoint's call), at one
   (series, day) of the corpus (~143 points, 24 windows) and at a week
   of one series at 1 s (604,800 points, 168 windows): two calls
   bit-identical, every output bit for bit against its plain version
   (which follows the kernel's order of addition), the records the host
   fold's (count, min, max, first, last and the brackets exact, the sum
   within rtol 1e-12) through ``window_fold`` and the tier's entries
   (``group_summaries_device``, also byte for byte against its CPU run,
   and ``window_summaries_device``); the group entry's host-inclusive
   time beside one pass of the one-series entry over the same series
   and resolutions and of the host fold; beside the plain version of a
   series, a three-call scatter composite (no single PyTorch call
   computes it). A child process (beside the path phase, see "Overlap")
   counts, under ``torch.profiler``, the fold kernels of 3, 20 and 5
   calls of ``group_summaries_device`` at the three shapes: the kernels
   line's ``kernels_per_call`` is that count, and anything but one fold
   kernel a call, or any other device event but copies, fails. The
   smoothing
   scans (``csrc/smoothing.cu``) at ``/forecast``'s two grids, made from
   the corpus (each series' hourly means, 10,000 x 169 time-major; each
   dc's five-minute sums, 10 x 2,017): the fused Holt-Winters fit, bands
   and forecast (season 24 and 288, horizon 24) and the EWMA, each bit
   for bit against its plain version on the card (a Python loop over T,
   timed over 3 runs), timed three ways, beside the byte / operation
   bound and the chain's floor (T dependent steps at ~4 cycles an
   operation, at the card's maximum SM clock; ``binds`` says which is
   larger); a child process (beside the path phase) counts, under
   ``torch.profiler``, the smoothing kernels of one ``/forecast`` model
   step at each grid
   (exactly one, and no other device event but copies).
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
4b. Forecast phase, on the path phase's daemon at full width, after the
   observability phase: ``/forecast`` of ``sum:1h-avg{host=*}`` (10,020
   series x 169 hours) with ``season=24&horizon=24``, the same with
   ``model=ewma``, and ``sum:5m-avg{dc=*}`` (10 x 2,017) with
   ``season=288``. Each must launch exactly one kernel of its model
   (counted around the request); the same steps then run in process,
   timed apart (``executor.run`` of the series, the grid, the model step
   with its copies, the JSON build): the model's outputs bit for bit
   against the plain versions on the card, and the HTTP answer against
   them (tags and timestamps equal, values within float32 tolerance,
   anomaly flags equal but at cells within that tolerance of a band: the
   resident sums' atomics add in a run-dependent order). One
   ``forecast`` stdout line, with the kernels' cases and the rollup
   child's approximate-serving results.
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
5b. Sharded phase, beside the path phase: the daemon over a SHARDS-shard
   store (``storage/sharded.py``, ``tsdb tsd --shards 4 --wal-group-ms 2``)
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
   masked_select. The fused plan's mesh leg (``fused_mesh_phase``): a
   second in-process executor over the same store with a mesh of
   FUSED_MESH_D (4) logical shards of the card runs the ten queries
   cold, with the leg's launches counted (block_decode, segment_sum,
   segment_minmax and moment_combine must each launch) and every
   moment_combine payload held bit for bit against its plain version,
   and FUSED_WARM_REPS times warm; each answer must match the daemon's
   single-device fused answer (max exact) and REFERENCE within the
   resident tolerance; each cut's point count a shard is kept; the leg's
   whole body is held against its plain version (every kernel replaced
   by its plain version) at the week's full gather and timed like a
   kernel beside its byte bound; one query at D = 3 must count
   ``mesh-indivisible`` and serve fused on one device. One ``fused_mesh``
   stdout line. One ``bench.int`` query must equal the raw scan's
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
5e. Rollup phase (``rollup/``), beside the path phase, over the
   first ROLLUP_SERIES (2,500) series of the corpus (the cut and its
   reason print first): a daemon with the rollup tier on and the window
   off (it would answer first), default ``Config`` otherwise. Checkpoint
   1 (fold s, records, tier bytes, ``rollup.fold`` with its declared
   kind); six ``/q`` shapes, each ``"rollup": "1h"`` or ``"1d"``, cold and
   WARM_REPS times warm, and once under ``torch.profiler`` (card time),
   with the segment and select launch counts set to 0 before and read
   after (each must launch); each held on the float64 oracle backend
   against a raw scan with the tier set aside (bit-equal: every bucket
   is one window), and the card's answer against that oracle answer.
   ``sum:rate:1h-avg`` and ``sum:1h-p95`` over a day must be declined
   (``raw``), each counted under its reason. A telnet backfill into a folded hour
   makes it dirty: the next answer is stitched from raw (bit-equal to
   the raw scan again). Checkpoint 2; the ranged week ``/sketch`` (``1d``,
   ``X-Tsd-Approx``) and ``/distinct`` (``rollup``: 2,500 hosts). A
   restart adopts the tier (no rebuild, the same answers); a second
   backfill, then a checkpoint whose fold raises (the ``rollup.fold.start``
   fault point) and process death: the reopen catches the in-flight
   windows up (one rebuild) with the answers of before the crash. Then a
   TSDB folding the same series on the card (``rollup_device_fold``):
   ``rollup_fold``'s launches counted over its checkpoint (must be > 0
   and at most one a (metric, coarse day) group) beside the groups, its
   fold s beside the host fold's, every record against the host tier's
   (count, min, max, first, last and the brackets exact, the sum within
   rtol 1e-12, the sketch cells byte-identical) and every group's
   records byte for byte against the plain version's on the host. The
   kernel phase's child also counts the tier's own group call (the first
   day of the 2,500 series: exactly one fold kernel a call, nothing but
   copies besides), reported here. Between the
   ranged routes and the restart, approximate serving
   (``sketch/serving.py``): ``sum:1h-p95`` with ``approx=1``
   (``approx-1h``, moment columns) and ``max:1d-p99{dc=*}`` with
   ``max_error=10`` (``approx-1d``, t-digests), each declaring its bound
   per result and in ``X-Tsd-Approx`` and lying within it of the exact
   answer bucket for bucket; ``max_error=1e-9`` (unmet) and the plain
   query answer exactly (``raw``); ``/api/queries`` counts two
   ``approx`` plans. After the crash reopen, a tier under
   ``sketch_byte_budget`` (300,000 B, the first 200 series, one
   checkpoint) and ``tsdb sketch-plan --sketch-byte-budget`` on its
   store. One ``rollup`` stdout line.
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
5f. Replica phase (ROADMAP item 10a), last in the restart phase, over
   its writer and its store (10,020 series, 10M points in two
   generations): a replica opened as ``tsdb tsd --role replica`` opens it
   (``cli.make_tsdb`` read-only: no window, no tenant accounting) with a
   ``WalTailer`` (0.25 s) and a daemon of its own; its boot seconds split
   into generations, replay and sketch load. With the launch counts set to
   0 and a ``KernelTap`` recording every call of the seven kernels and the
   thread that makes it, ``sum:1h-avg{dc=*}`` and ``p95:1h-avg{dc=*}``
   over the first day and ``max:1h-max{host=h00001}`` over the week (each
   ``"rollup": "raw"``: the scan path) and the seven sketch routes run on
   the replica; segment_sum, segment_minmax, masked_select, hll_estimate
   and merged_quantile must each count launches, from the replica
   daemon's threads too. Each ``/q`` answer is held against the writer's
   (resident) one: tags and timestamps equal, values within rtol 1e-5 +
   1e-5 x scale; every sketch route answers the writer's bytes. Then 200
   telnet points into the writer's telnet series (an hour past the week)
   and the time until the replica's ``/q`` holds all of them (the tail
   lag), ``/healthz`` before and after; a writer checkpoint, the
   replica's rebuild and sketch reload timed apart (the tailer stopped),
   after which every sketch route answers the writer's bytes; three more
   checkpoints, each followed by the WAL suffix the writer ingests in one
   tail interval at the path phase's rate (through ``add_batch``), so
   each ``refresh_replica`` re-folds that suffix on the card:
   tdigest_fold and hll_fold must count launches, from the new sketch
   set's folder thread too; the card's allocated memory, read around
   each refresh (the writer shares the process), must grow by no more
   than 1 MiB over the three, the replaced set's stacks must be freed
   and its folder thread ended; every sketch route must then answer the
   writer's bytes. Then failover: the writer stops, the epoch file is
   bumped, ``TSDB.promote`` takes the store (seconds, split into store,
   sketches, tenants, rollups), the WAL must begin with that epoch's
   header, and 200 telnet points into the promoted replica must answer.
   Last, every recorded replica call is replayed on the card against the
   kernel's plain version (the kernel and sketch phases' tolerances), and
   the largest call of each kernel is timed as those phases time theirs
   (stages ``replica <what ran>: <shape>``). The sharded child opens a
   replica of its 4-shard store after its fsck (one day's
   ``sum:1h-avg{dc=*}`` against the writer's), and the rollup child one
   of its store after the crash reopen (the six rollup shapes, each with
   the writer's plan, max and percentiles exactly, sums by the resident
   tolerance; where a body is not the writer's bytes, the kernel calls
   of both queries must have had the same inputs bit for bit, and the
   group sum runs 20 times on the writer's input to count its different
   outputs). One ``replica`` stdout line.
5g. Router phase (ROADMAP item 10b), in the restart phase just before
   the replica phase, over the same writer and store: two replicas opened
   as 5f opens one, each with its tailer and daemon, and in front of them
   a router started as ``tsdb tsd --role router`` does, as its own process
   (``python -X importtime -m opentsdb_tpu_torch.tools.cli``: its boot s,
   spawn to the ready line, and every module it imported, where torch,
   jax, the storage engine, the core, the daemon or the ops fail the
   smoke), over both replicas, forwarding puts to the writer's daemon.
   First, uncounted, the replica phase's three ``/q`` from their owner
   replicas, then HOP_REPS (5) runs of the day's p95 direct and through
   the router in turns (the hop's overhead). Then, with the launch counts
   set to 0 and a ``KernelTap`` open, routed requests only: the three
   ``/q`` through the router, each held against its owner replica's own
   answer (max and percentiles exactly, the sum by the resident
   tolerance; ``identical`` says whether the bytes are), the day's p95
   with the owner's listener stopped (the router must count a retry and
   answer from the other replica), then through a second router process
   whose hops hedge after 1 ms (it must count a hedge); the counts are
   read right after. Each routed request must have launched a kernel on
   a replica's threads, and segment_sum, segment_minmax and
   masked_select must each have launched for one.
   Twenty telnet puts through the router into the telnet series (two
   days past the week) must come back through the router and stand in
   the writer. Both routers stop on SIGTERM with exit 0. Every recorded
   replica call is then replayed against its plain version and the
   largest of each kernel timed (stages ``router <what ran>: <shape>``).
   The rollup child ends with the degraded and failover leg over its
   store: the store reopened as a ``--cluster`` writer, one ``--cluster``
   replica with its tailer and the tier read-only, a router process with
   ``--writer-grace-ms`` 1000. ``max:1h-p95`` over the week's first day
   through the router with ``degrade=rollup-only`` must answer 200 tagged ``rollup-only`` (header
   and each result) with ``X-Tsd-Approx``, every bucket within its
   declared ``error`` of the writer's exact answer; ``sum:`` without a
   downsample must answer 503 with Retry-After. Then the writer's listener
   stops (its TSDB stays up: a zombie holding its locks): the router must
   promote the replica (its ``/api/topology`` event) and a put through the
   router must be acked by the promoted daemon and read back through the
   router (seconds from the stop to each). The old writer must refuse a
   put (fenced), and, its listener back on its port, be demoted by the
   router and tail the promoted writer's point. One ``router`` stdout
   line.
5h. Mesh phase (ROADMAP item 11a), beside the path phase in a child
   process (``mesh_phase``): the corpus into a TSDB whose resident window
   is the mesh-sharded one (``devwindow_shards`` MESH_D = 4, each shard a
   quarter of the budget), behind a daemon whose executor holds
   ``Mesh([cuda:0] * 4)``: four logical shards of one card, so the phase
   measures the per-shard work and the combines and no interconnect. The
   ten ``/q`` shapes resident (``_dw_sharded_stage``) against REFERENCE
   (max exactly, the rest at the resident tolerance); ``/healthz`` and
   ``/api/queries`` report width 4; ``/api/mesh/reshard`` to 2 and back to
   4 while a thread's telnet puts flow (each reshard's ms; the ten answers
   unchanged; every acknowledged flow point served resident afterwards);
   then, the window set aside, the scan legs MESH_SCAN (series-sharded
   day, multigroup day and ``{host=*}`` week, time-sharded
   ``{host=h00001}`` week), each dispatched through the plane and held
   against the same TSDB's single-device executor, the two combine
   kernels' launches counted there and every payload they took held bit
   for bit against their plain versions; the plane's compile cache live.
   The kernel phase times both kernels at those shapes (MESH_CASES,
   ``mesh_kernel_phase``). One ``mesh`` stdout line. Since item 11b the
   executor's mesh is those four shards folded 2 x 2 (``tsd --mesh 2x2``)
   and the daemon runs ``--expert-parallel``; last in the child, the
   expert dashboard (``expert_leg``): one ``/q`` over the corpus's first
   day with EXPERT_PANELS (sum / max / dev / p95 / p50, each ``{dc=*}``
   at 1h: 50 slots of ~143k points at S = 1,024, B = 32) through the
   expert path (the launches of that first run alone: ``dash_finish``,
   once a shard, the segment kernels, ``masked_select``; every
   ``dash_finish`` payload held against its plain version: fills, masks,
   counts, min and max bit for bit, sums at float32 tolerance),
   EXPERT_REPS runs each of
   the expert path, the serial scan path (expert off, window set aside:
   the comparison the JAX path's host scan asks for) and the resident
   path, every expert answer against the serial scan's (max exactly, the
   rest at the resident tolerance, percentiles' identical groups
   counted), and a second request with the rate panel, which must
   decline whole (``expert-decline`` per result, six decline counts) with
   the five panels' answers unchanged. One ``expert`` stdout line.
5i. Fleet phase (item 11b), beside the path phase in a child process
   (``fleet_phase``): the three hybrid bodies (group at sum and dev,
   HLL, t-digest) over the corpus's week on ``Mesh([cuda:0] * 4)``
   folded 2 x 2 (10M points, 2,500 series a shard), their launches
   counted, the group against the single-device kernels, the HLL within
   5% and the quantiles within SKETCH_RANK_TOL in rank of the exact
   values, every ``hybrid_moment_combine`` payload held bit for bit
   against its plain version and against the cross-process sequence on
   it (each row's emit, the rows gathered, the finish over [2, 1, B]);
   then ``tools/multihost_run.py --device cuda`` in its default mode and
   ``--serve``: two gloo processes on the card whose cross-process
   answers must equal a one-process run's bit for bit (the default mode
   at the same week shapes: 10,000 series of 1,000 points in 2 x 2
   shards, B = 256, each process one host row). The kernel phase
   times ``dash_finish`` at a moment shard's whole finish and a
   percentile shard's fill, at the day (S = 1,024, B = 32) and the week
   (B = 256), each A B B A against the chain it replaced (the per-cell
   finish kernel, ``gap_fill``, ``group_moments``, the per-cell finish
   again), and the hybrid combine at the week group
   (``expert_kernel_phase``). One ``fleet`` stdout line.
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
   launch-floor lines, the compressed, forecast, rollup, replica, router
   mesh, expert and fleet lines, the kernels line (sixteen kernels; the
   two mesh combines' path is ``mesh``, ``dash_finish``'s ``expert`` and
   ``hybrid_moment_combine``'s ``hybrid``, their other shapes under
   ``other_cases``)
   and, last, the ok line.
   In the kernels line each kernel's top-level numbers are its first
   path's: the segment kernels' and the select's the resident path's
   (at the chunk-fold shape and the columns select at one quantile),
   interp_moments' the un-downsampled path's (at the one-day {dc=dc0}
   shape; its full-width numbers under ``full_width``), the sketch
   kernels' the sketch path's (their other shapes under
   ``other_cases``), rollup_fold's the device-folded checkpoint's (at the
   group shape; the (series, day) and the week under ``other_cases``),
   the smoothing
   kernels' the forecast path's (at the ``{host=*}`` 1h grid; the
   five-minute grid under ``other_cases``; with ``bytes_bound_ms``,
   ``chain_floor_ms``, ``launch_floor_ms``, ``binds`` and ``share``
   beside ``bound_ms``). Under ``paths``
   each path's launches stand beside the times at its own shape (the scan
   path's: the series stage; the select's un-downsampled path: the p95
   contributions; the replica path's: its own largest call of each
   kernel; the router path's, ``router``: the largest call the replicas
   made for a routed request). Counts include the group stages' launches, whose times are
   in the details line.

Overlap: after the kernel phase the sharded phase (with its writer-pause
A/B), the rollup phase, the mesh phase and the fleet phase each run in a
child process of this script
(``--child <phase>``) while the path phase runs here, and so do the two
kernel-count children (the fold's and the smoothing kernels', ``python
-c``, started once every kernel case is timed); the sharded and mesh
children wait for the path phase's answers (REFERENCE, written to a
shared file) before they compare their own. All are joined before the compressed phase,
whose decode-kernel timings so run on an otherwise idle card. They share
the machine's cores and the card while they overlap, so their host times
are not those of a phase run alone. Each child dies with this process
(the count children are killed if it fails first), and its result comes
back as JSON.

Any failure raises and exits nonzero before the last line. Without a CUDA
card, or without the package beside it, it exits nonzero and prints no
result. The full details go to standard error as one JSON line; every
standard-error line starts with the seconds since the smoke began (and
the child's phase).
"""

from __future__ import annotations

import asyncio
import contextlib
import ctypes
import gc
import http.client
import inspect
import io
import itertools
import json
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import weakref

import numpy as np
import torch

from opentsdb_tpu_torch.cluster import epoch as cepoch
from opentsdb_tpu_torch.compress import fused as cfused
from opentsdb_tpu_torch.compress import kernels as ckernels
from opentsdb_tpu_torch.compress.devcache import pad_fine
from opentsdb_tpu_torch.core.errors import FencedWriterError
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.obs.registry import METRICS
from opentsdb_tpu_torch.fault import faultpoints
from opentsdb_tpu_torch.models import forecast as mforecast
from opentsdb_tpu_torch.models import smoothing as msmooth
from opentsdb_tpu_torch.ops import (block_decode, cuda_build, expert_finish,
                                    interp_moments, kernels as wk,
                                    masked_select, mesh_combine, oracle,
                                    rollup_fold, segment_reduce, sketches,
                                    smoothing)
from opentsdb_tpu_torch.parallel import compile as mesh_plane
from opentsdb_tpu_torch.parallel import expert as pexpert
from opentsdb_tpu_torch.parallel.mesh import Mesh
from opentsdb_tpu_torch.parallel.multihost import (hybrid_downsample_group,
                                                   hybrid_hll_distinct,
                                                   hybrid_tdigest,
                                                   make_hybrid_mesh)
from opentsdb_tpu_torch.parallel.sharded import pack_shards
from opentsdb_tpu_torch.query.aggregators import Aggregators
from opentsdb_tpu_torch.query.executor import (QueryExecutor, QueryResult,
                                               QuerySpec, _filter_key,
                                               _pad64, _pad_size, _Span)
from opentsdb_tpu_torch.query.grammar import parse_m
from opentsdb_tpu_torch.rollup import summary as rsummary
from opentsdb_tpu_torch.serve.tailer import WalTailer
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.sketch.bounds import hll_error
from opentsdb_tpu_torch.stats.livesketch import LiveSketches
from opentsdb_tpu_torch.stats.livesketch import _pad as _sk_pad
from opentsdb_tpu_torch.storage.devstore import DeviceWindow
from opentsdb_tpu_torch.storage import kv as port_kv
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.tenant.accounting import hll_rel_error
from opentsdb_tpu_torch.tools import cli as port_cli
from opentsdb_tpu_torch.tools.cli import open_tsdb
from opentsdb_tpu_torch.tools.compare_kernels import decode_inputs
from opentsdb_tpu_torch.tools.fsck import run_fsck
from opentsdb_tpu_torch.tools import multihost_run
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
WARM_REPS = 3                 # warm /q runs per query, after the first
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


# The smoke's start on the wall clock (a child gets its parent's) and the
# phase a child process runs: the head of every standard-error line.
START = time.time()
LOG_TAG = ""
# The directory the path phase writes REFERENCE into and the children
# write their results into (see "Overlap" in the module docstring).
SHARE_DIR = ""
CHILD_PHASES = ("sharded", "rollup", "mesh", "fleet")
REFERENCE_WAIT_S = 900


def log(msg: str) -> None:
    print(f"[{time.time() - START:7.1f} s{LOG_TAG}] {msg}", file=sys.stderr,
          flush=True)


def write_json(path: str, obj) -> None:
    """``obj`` as JSON at ``path``, whole or not at all (tmp + rename)."""
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def publish_reference() -> None:
    """REFERENCE's one-shard answers for the sharded phase's child."""
    if SHARE_DIR:
        write_json(os.path.join(SHARE_DIR, "reference.json"),
                   {k: REFERENCE[k] for k in ("resident", "union")})


def reference() -> dict:
    """REFERENCE; in the sharded child, read from the file the path phase
    writes, waiting for it."""
    if "resident" not in REFERENCE and SHARE_DIR:
        path = os.path.join(SHARE_DIR, "reference.json")
        deadline = time.time() + REFERENCE_WAIT_S
        while not os.path.exists(path):
            if time.time() > deadline:
                fail(f"no reference answers after {REFERENCE_WAIT_S} s")
            time.sleep(0.5)
        with open(path) as f:
            REFERENCE.update(json.load(f))
        log("read the path phase's reference answers")
    return REFERENCE


def start_child(phase: str) -> subprocess.Popen:
    """This script with ``--child phase``: its standard output goes to
    standard error, so this process alone prints the result lines."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", phase,
         SHARE_DIR, repr(START), str(os.getpid())],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdin=subprocess.DEVNULL, stdout=sys.stderr)


def join_child(phase: str, proc: subprocess.Popen) -> dict:
    rc = proc.wait()
    if rc != 0:
        fail(f"the {phase} phase's process exited with code {rc}")
    with open(os.path.join(SHARE_DIR, f"{phase}.json")) as f:
        got = json.load(f)
    NATIVE_STAGES.update(got["native"])
    return got["out"]


def stop_children(children: dict) -> None:
    for proc in children.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def child_main(phase: str, share: str, start: float, parent: int) -> int:
    """One phase of CHILD_PHASES in its own process: its result and the
    native calls of its stages to ``<share>/<phase>.json``."""
    global START, LOG_TAG, SHARE_DIR
    START, LOG_TAG, SHARE_DIR = start, f" {phase}", share
    # Die with the parent (PR_SET_PDEATHSIG = 1), and at once if it is
    # already gone.
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)
    if os.getppid() != parent or not torch.cuda.is_available():
        return 1
    ts, vals = corpus()
    if phase == "sharded":
        out = sharded_phase(ts, vals)
        REFERENCE.clear()
        out["writer_pause"] = writer_pause_phase(ts, vals)
    elif phase == "mesh":
        out = mesh_phase(ts, vals)
    elif phase == "fleet":
        out = fleet_phase(ts, vals)
    else:
        out = rollup_phase(ts, vals)
    write_json(os.path.join(share, f"{phase}.json"),
               {"out": out, "native": NATIVE_STAGES})
    log(f"{phase} phase done")
    return 0


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

    def __init__(self, tsdb: TSDB, executor=None) -> None:
        self.server = TSDServer(tsdb)
        if executor is not None:
            # An executor of the smoke's own (the mesh phase's logical
            # shards on one card, which the daemon's --mesh refuses).
            self.server.executor = executor
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
        try:
            self.loop.run_until_complete(self.server.serve_forever())
        except BaseException as e:  # reported by stop
            self._error = e

    @property
    def port(self) -> int:
        return self.server.port

    def stop(self) -> None:
        """Stop the server, which shuts the TSDB down (a checkpoint, the
        store closed); a second call does nothing. A stop that raised (the
        shutdown's checkpoint among others) fails the smoke."""
        if self.thread.is_alive():
            self.loop.call_soon_threadsafe(self.server.request_shutdown)
            self.thread.join(600)
            if self.thread.is_alive():
                fail("daemon did not stop")
        if self._error is not None:
            err, self._error = self._error, None
            fail(f"the daemon's stop raised {err!r}")


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
        publish_reference()
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
        out["forecast"] = forecast_phase(daemon)

        out["restart"] = restart_phase(tsdb, daemon,
                                       os.path.join(wal_dir, "wal"),
                                       out["ingest"]["points_per_s"])
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


def restart_phase(tsdb: TSDB, daemon: "Daemon", wal: str,
                  ingest_rate: float) -> dict:
    """Checkpoint the ingested store, add a few hundred telnet puts and
    checkpoint again (two generations), shut the daemon down (which
    checkpoints once more), open a new TSDB and daemon on the same WAL
    (timing the generations' open, the replay and the window's warm-up
    from the tiers), then the resident queries against their answers
    from before the restart and one un-downsampled query and one host
    scan over the generations; last the replica phase (``ingest_rate``:
    the path phase's points/s)."""
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
        # Two replicas of this store behind a router process.
        out["router"] = router_phase(tsdb2, daemon2, wal)
        # Last: a replica of this store, which ends with the writer
        # stopped and the replica promoted in its place.
        out["replica"] = replica_phase(tsdb2, daemon2, wal, ingest_rate)
    finally:
        daemon2.stop()
    out["marker_rebuild"] = marker_rebuild(wal, tenants_before)
    return out


# ---------------------------------------------------------------------------
# Kernel tap: the inputs a daemon's path gives each kernel
# ---------------------------------------------------------------------------

# The replica path's kernel wrappers, each under every name it is called
# by (ops/kernels.py imports the segment wrappers by name; the others are
# called through their modules).
TAP_TARGETS = {
    "segment_sum": ((segment_reduce, "segment_sum"), (wk, "segment_sum")),
    "segment_minmax": ((segment_reduce, "segment_minmax"),
                       (wk, "segment_minmax")),
    "masked_select": ((masked_select, "select_columns"),
                      (masked_select, "select_groups")),
    "tdigest_fold": ((sketches, "tdigest_fold"),),
    "hll_fold": ((sketches, "hll_fold"),),
    "hll_estimate": ((sketches, "hll_estimate"),),
    "merged_quantile": ((sketches, "merged_quantile"),)}
REPLICA_KERNELS = tuple(TAP_TARGETS)
# Runs of the group sum on one recorded input, to see whether its float32
# sums (atomics, in a run-dependent order) change from run to run.
GROUP_SUM_REPEATS = 20


def tap_copy(x, fn):
    """``x`` with ``fn`` applied to every tensor in it (tuples, named
    tuples, lists and dicts walked)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tap_copy(v, fn) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tap_copy(v, fn) for v in x)
    if isinstance(x, dict):
        return {k: tap_copy(v, fn) for k, v in x.items()}
    return x


class TapCall:
    """One recorded wrapper call: the kernel, the entry point, the label
    the smoke had set, the calling thread, a copy of the arguments made
    before the call (the folds update their stacks in place) and the
    launches the call made."""

    def __init__(self, name, entry, label, args):
        self.name, self.entry, self.label = name, entry, label
        self.thread = threading.current_thread()
        self.args = args
        self.launched = 0


class _Tapped:
    """Stands in for a kernel wrapper while a KernelTap is open: records
    the call, then makes it. ``launches`` reads and writes the wrapper's
    own count, which the wrapper bumps through its module's name (this
    object while the tap is open)."""

    def __init__(self, tap: "KernelTap", name: str, entry: str, fn) -> None:
        self.tap, self.name, self.entry, self.fn = tap, name, entry, fn
        self.sig = inspect.signature(fn)

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n

    def __call__(self, *args, **kw):
        bound = self.sig.bind(*args, **kw)
        bound.apply_defaults()
        call = TapCall(self.name, self.entry, self.tap.label,
                       tap_copy(dict(bound.arguments), torch.Tensor.clone))
        n0 = self.fn.launches
        out = self.fn(*args, **kw)
        call.launched = self.fn.launches - n0
        self.tap.calls.append(call)
        return out


class KernelTap:
    """While open, every call of the replica path's kernel wrappers is
    recorded (``TapCall``) from whichever thread makes it; ``of`` keeps
    the calls of given threads, ``to_host`` moves the copies off the
    card (so a reading of its allocated memory leaves them out)."""

    def __init__(self) -> None:
        self.calls: list[TapCall] = []
        self.label = ""
        self._saved: list = []

    def __enter__(self) -> "KernelTap":
        proxies: dict = {}
        for name, entries in TAP_TARGETS.items():
            for mod, attr in entries:
                fn = getattr(mod, attr)
                if id(fn) not in proxies:
                    proxies[id(fn)] = _Tapped(self, name, attr, fn)
                self._saved.append((mod, attr, fn))
                setattr(mod, attr, proxies[id(fn)])
        return self

    def __exit__(self, *exc) -> bool:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()
        return False

    def of(self, threads) -> list:
        return [c for c in self.calls if c.thread in threads]

    def to_host(self) -> None:
        torch.cuda.synchronize()
        for c in self.calls:
            c.args = tap_copy(c.args, lambda t: t.cpu())


def pool_threads(daemon: "Daemon") -> set:
    """The threads a daemon runs its /q and sketch routes on."""
    return set(daemon.server._pool._threads)


def tap_counts(calls: list) -> dict:
    """Launches by kernel among ``calls``."""
    out = dict.fromkeys(REPLICA_KERNELS, 0)
    for c in calls:
        out[c.name] += c.launched
    return out


def same_arg_bits(a, b) -> bool:
    """Two recorded argument trees hold the same values, bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and same_bits(a, b)
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) \
            and all(same_arg_bits(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() \
            and all(same_arg_bits(a[k], b[k]) for k in a)
    return a == b


def _replay_segment_sum(a: dict) -> tuple:
    x, ids, ns = a["feat"], a["seg"], a["num_segments"]
    got = segment_reduce.segment_sum(x, ids, ns)
    want = segment_reduce.segment_sum_plain(x, ids, ns)
    torch.cuda.synchronize()
    # Float32 sums in another (run-dependent) order: the kernel phase's
    # tolerance.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    n, k = x.shape
    return ({"n": n, "k": k, "segments": ns,
             "max_abs_err": float((got - want).abs().max()) if got.numel()
             else 0.0},
            f"N={n:,} K={k} -> {ns:,} segments",
            bound_ms(n * k * 4 + n * 4 + ns * k * 4, n * k),
            lambda: segment_reduce.segment_sum(x, ids, ns),
            lambda: segment_reduce.segment_sum_plain(x, ids, ns),
            lambda: torch.zeros((ns, k), device=x.device).index_add_(
                0, ids, x))


def _replay_segment_minmax(a: dict) -> tuple:
    x, ids, ns, need = a["vals"], a["seg"], a["num_segments"], a["need"]
    got = segment_reduce.segment_minmax(x, ids, ns, need=need)
    want = segment_reduce.segment_minmax_plain(x, ids, ns, need=need)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            fail(f"segment_minmax ({need}): not exact on a replica input")
    n, k = x.shape
    outs = len(got)
    library = None
    if need != "both":
        fill = float("-inf") if need == "max" else float("inf")
        idx = ids.long()[:, None].expand(-1, k)
        library = (lambda: torch.full((ns, k), fill, device=x.device)
                   .scatter_reduce_(0, idx, x, "a" + need))
    return ({"n": n, "k": k, "segments": ns, "need": need,
             "max_abs_err": max((float((g - w).abs().nan_to_num(0.0).max())
                                 for g, w in zip(got, want) if g.numel()),
                                default=0.0)},
            f"N={n:,} K={k} -> {ns:,} segments, {need}",
            bound_ms(n * k * 4 + n * 4 + outs * ns * k * 4, outs * n * k),
            lambda: segment_reduce.segment_minmax(x, ids, ns, need=need),
            lambda: segment_reduce.segment_minmax_plain(x, ids, ns,
                                                        need=need),
            library)


def _replay_masked_select(a: dict, entry: str) -> tuple:
    x, m, q = a["vals"], a["mask"], a["q"]
    layout = a.get("layout")
    if entry == "select_columns":
        def fn():
            return masked_select.select_columns(x, m, q)

        def plain():
            return masked_select.select_columns_plain(x, m, q)
        G, extra = 1, 0
        qt = torch.tensor(masked_select._q_list(q), device=x.device)
        nan_grid = torch.where(m, x, float("nan"))

        def library():
            return torch.nanquantile(nan_grid, qt, dim=0,
                                     interpolation="linear")
    else:
        def fn():
            return masked_select.select_groups(x, m, layout, q)

        def plain():
            return masked_select.select_groups_plain(x, m, layout, q)
        G = layout.offsets.numel() - 1
        extra = 4 * (x.shape[0] + G + 1 + layout.big.numel())
        library = None
    got, want = fn(), plain()
    torch.cuda.synchronize()
    # Both select exact rank keys and lerp with separate roundings.
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    rows, cols = x.shape
    nq = len(masked_select._q_list(q))
    return ({"rows": rows, "cols": cols, "groups": G, "quantiles": nq,
             "max_abs_err": float((got - want).abs().nan_to_num(0.0).max())
             if got.numel() else 0.0},
            f"[{rows:,}, {cols:,}] into {G:,} group(s), {nq} quantile(s)",
            bound_ms(rows * cols * 5 + extra + nq * G * cols * 4,
                     rows * cols),
            fn, plain, library)


def _replay_tdigest_fold(a: dict) -> tuple:
    m0, w0, idx, batch = a["means"], a["weights"], a["idx"], a["batch"]
    valid, bw, K = a["valid"], a["batch_weights"], a["compression"]
    m1, w1, m2, w2 = m0.clone(), w0.clone(), m0.clone(), w0.clone()
    sketches.tdigest_fold(m1, w1, idx, batch, valid=valid, batch_weights=bw,
                          compression=K)
    sketches.tdigest_fold_plain(m2, w2, idx, batch, valid, bw,
                                compression=K)
    torch.cuda.synchronize()
    # Weights: integral float32 sums, exact; means: the sketch phase's
    # tolerance.
    if not torch.equal(w1, w2):
        fail("tdigest_fold: cluster weights differ on a replica input")
    torch.testing.assert_close(m1, m2, rtol=1e-5, atol=1e-6)
    live = valid if valid is not None else bw > 0
    keys = fold_sort_keys(idx, batch, live, m0, w0)
    m, w = m0.clone(), w0.clone()
    mp, wp = m0.clone(), w0.clone()
    rows = int((idx < m0.shape[0]).sum())
    P = batch.shape[1]
    return ({"rows": rows, "K": K, "P": P,
             "max_abs_err": float((m1 - m2).abs().max())},
            f"{rows:,} rows x ({K} + {P:,}) entries",
            fold_bound(idx, live, m0, w0),
            lambda: sketches.tdigest_fold(m, w, idx, batch, valid=valid,
                                          batch_weights=bw, compression=K),
            lambda: sketches.tdigest_fold_plain(mp, wp, idx, batch, valid,
                                                bw, compression=K),
            lambda: torch.sort(keys, dim=1))


def _replay_hll_fold(a: dict) -> tuple:
    regs0, idx, items, valid, p = (a["regs"], a["idx"], a["items"],
                                   a["valid"], a["p"])
    r1, r2 = regs0.clone(), regs0.clone()
    sketches.hll_fold(r1, idx, items, valid, p=p)
    sketches.hll_fold_plain(r2, idx, items, valid, p=p)
    torch.cuda.synchronize()
    if not torch.equal(r1, r2):
        fail(f"hll_fold p={p}: registers differ on a replica input")
    C = regs0.shape[0]
    keep = (idx >= 0) & (idx < C)
    reg_idx, rank = sketches._hll_ranks(items[keep], valid[keep], p)
    tgt = torch.zeros((int(keep.sum()), (1 << p) + 1), dtype=torch.int32,
                      device=regs0.device)
    live = reg_idx < (1 << p)
    slots = idx[keep].long()[:, None].expand_as(reg_idx)
    touched = int(torch.unique(slots[live] * (1 << p)
                               + reg_idx[live]).numel())
    raised = int((r2 != regs0).sum())
    n_items = int(valid[keep].sum())
    # Each timed call folds into a stack of its own, as it stood before
    # the call (as the sketch phase times the fold).
    stacks = itertools.cycle([regs0.clone() for _ in range(64)])
    rp = regs0.clone()
    return ({"p": p, "rows": list(items.shape), "items": n_items,
             "touched": touched, "raised": raised, "max_abs_err": 0.0},
            f"{items.shape[0]} x {items.shape[1]:,} items ({n_items:,} "
            f"valid), p = {p}",
            bound_ms(int(keep.sum()) * items.shape[1] + 4 * n_items
                     + 4 * touched + 4 * raised, 10 * n_items),
            lambda: sketches.hll_fold(next(stacks), idx, items, valid, p=p),
            lambda: sketches.hll_fold_plain(rp, idx, items, valid, p=p),
            lambda: tgt.scatter_reduce_(1, reg_idx, rank, "amax"))


def _replay_hll_estimate(a: dict) -> tuple:
    regs = a["registers"]
    got = sketches.hll_estimate(regs)
    want = sketches.hll_estimate_plain(regs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    if not torch.equal(torch.round(got), torch.round(want)):
        fail("hll_estimate: rounded estimates differ on a replica input")
    rows = regs.numel() // regs.shape[-1]
    return ({"rows": rows, "max_abs_err": float((got - want).abs().max())},
            f"{rows} x {regs.shape[-1]:,} registers",
            bound_ms(regs.numel() * 4 + rows * 4, 3 * regs.numel()),
            lambda: sketches.hll_estimate(regs),
            lambda: sketches.hll_estimate_plain(regs), None)


def _replay_merged_quantile(a: dict) -> tuple:
    m, w, idx, valid, q, K = (a["means"], a["weights"], a["idx"],
                              a["valid"], a["q"], a["compression"])
    got = sketches.merged_quantile(m, w, idx, valid, q, compression=K)
    again = sketches.merged_quantile(m, w, idx, valid, q, compression=K)
    want = sketches.merged_quantile_plain(m, w, idx, valid, q,
                                          compression=K)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail("merged_quantile: two runs on one replica input differ")
    # The sketch phase's tolerance (a cluster's mean sums many centroids
    # in another order than the plain version's atomics).
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    rows = idx[valid].long()
    keyf = torch.where(w[rows] > 0, m[rows],
                       torch.full_like(m[rows], float("inf")))
    comp = sketches._sort_keys(keyf.reshape(-1))
    live = (w[rows] != 0).sum().reshape(1)
    S = idx.shape[0]
    return ({"S": S, "valid": len(rows), "K": K,
             "live_entries": int(live),
             "max_abs_err": float((got - want).abs().max())},
            f"S = {S:,} ({len(rows):,} valid), {q.numel()} quantile(s)",
            sort_bound(len(rows) * K * 8 + S * 5 + q.numel() * 8, live),
            lambda: sketches.merged_quantile(m, w, idx, valid, q,
                                             compression=K),
            lambda: sketches.merged_quantile_plain(m, w, idx, valid, q,
                                                   compression=K),
            lambda: torch.sort(comp))


def arg_bytes(args: dict) -> int:
    sizes: list = []
    tap_copy(args, lambda t: sizes.append(t.numel() * t.element_size()))
    return sum(sizes)


def replica_kernel_cases(calls: list, what: str) -> tuple[list, list]:
    """Every call in ``calls`` (recorded on ``what``'s path) replayed on
    the card: the wrapper against its plain version on the same inputs,
    at the kernel and sketch phases' tolerances. Of each kernel, the call
    with the most input bytes is timed as those phases time theirs,
    under the stage ``<what> <label>: <shape>``. Returns the timed cases
    and every call's check."""
    dev = torch.device(DEVICE)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    checks, biggest = [], {}
    for c in calls:
        a = tap_copy(c.args, lambda t: t.to(dev))
        if c.name == "masked_select":
            rec = _replay_masked_select(a, c.entry)
        else:
            rec = globals()[f"_replay_{c.name}"](a)
        res, shape = rec[0], rec[1]
        checks.append({"name": c.name, "label": c.label, "shape": shape,
                       "launched": c.launched, **res})
        size = arg_bytes(c.args)
        if size > biggest.get(c.name, (-1,))[0]:
            biggest[c.name] = (size, c, a, rec)
        del a
    cases = []
    for name, (_, c, a, (res, shape, bound, fn, plain, library)) in \
            biggest.items():
        cases.append(time_case(
            {"name": name, "stage": f"{what} {c.label}: {shape}", **res,
             "bound_ms": bound[0], "bound_by": bound[1]},
            fn, plain, library, flush))
    del biggest, flush
    torch.cuda.empty_cache()
    return cases, checks


# ---------------------------------------------------------------------------
# Replica phase: a read-only replica tailing the restarted writer
# ---------------------------------------------------------------------------

# The replica's /q shapes, each with the length of its range from BASE.
REPLICA_QUERIES = [("sum:1h-avg:bench.metric{dc=*}", DAY),
                   ("max:1h-max:bench.metric{host=h00001}", SPAN),
                   ("p95:1h-avg:bench.metric{dc=*}", DAY)]
# The kernels of the replica's path: its scan-path queries', its sketch
# routes' and its sketch reload's.
REPLICA_QUERY_KERNELS = ("segment_sum", "segment_minmax", "masked_select")
REPLICA_SKETCH_KERNELS = ("hll_estimate", "merged_quantile")
REPLICA_RELOAD_KERNELS = ("tdigest_fold", "hll_fold")
# Points the replica phase adds, to existing telnet series only (so the
# tenant totals marker_rebuild checks stay as they are), in hours past the
# corpus' week: TAIL_POINTS at hour 0 for the tail lag, RELOAD_POINTS
# before each of RELOADS writer checkpoints at hours 1..RELOADS,
# TAIL_POINTS at hour PROMOTED_HOUR after the promotion; from
# SUFFIX_HOUR0 on, each checkpoint's WAL suffix: what the writer ingests
# in one tail interval at the path phase's rate, one point a second a
# series.
REPLICA_HOUR0 = BASE + SPAN
TAIL_POINTS, RELOAD_POINTS, RELOADS = 200, 20, 3
PROMOTED_HOUR = RELOADS + 1
SUFFIX_HOUR0 = RELOADS + 2
# How far the card's allocated memory may move across the reloads, in
# the replica's own steps (the writer shares the process and the card).
RELOAD_MEMORY_SLACK = 1 << 20


def open_replica_tsdb(wal: str, **over) -> TSDB:
    """The TSDB as ``tsdb tsd --role replica`` opens it (tools/cli.py
    cmd_tsd: ``make_tsdb`` read-only, the role's 5,000 ms staleness
    contract and 0.25 s tail interval), then the heap frozen."""
    cfg = Config(auto_create_metrics=True, port=0, bind="127.0.0.1",
                 device=DEVICE, role="replica", max_staleness_ms=5000.0,
                 tail_interval_s=0.25, **over)
    tsdb = port_cli.make_tsdb(cfg, wal, read_only=True)
    tune_for_ingest()
    if tsdb.devwindow is not None or tsdb.tenants is not None \
            or not tsdb.store.read_only:
        fail("the replica came up with the window, tenant accounting or "
             "a writable store")
    return tsdb


def replica_daemon(tsdb: TSDB) -> tuple["Daemon", WalTailer]:
    """A daemon over the replica with its WAL tailer attached and
    running, as cmd_tsd --role replica starts it."""
    daemon = Daemon(tsdb)
    tailer = WalTailer(tsdb)
    daemon.server.attach_tailer(tailer)
    tailer.start()
    return daemon, tailer


def q_body(port: int, expr: str, start: int, end: int) -> tuple:
    """One /q's wall ms and body (JSON)."""
    target = "/q?" + urllib.parse.urlencode(
        {"start": start, "end": end, "m": expr, "json": ""})
    q0 = time.perf_counter()
    status, body = http_get(port, target)
    wall = (time.perf_counter() - q0) * 1e3
    if status != 200:
        fail(f"{expr}: HTTP {status}: {body[:300]!r}")
    return wall, body


def q_json(port: int, expr: str, start: int, end: int) -> tuple[float, list]:
    wall, body = q_body(port, expr, start, end)
    return wall, json.loads(body)


def replica_put_lines(hour: int, per_series: int) -> list[str]:
    """Points for the existing telnet series, each at its own second of
    the hour ``hour`` past the week, so a zimsum over that hour has one
    bucket per point."""
    t0 = REPLICA_HOUR0 + hour * 3600
    return [f"put bench.metric {t0 + s * per_series + j} "
            f"{100 + s + j / 8:.3f} host=t{s:02d} dc=dc{s % 10}"
            for s in range(TELNET_SERIES) for j in range(per_series)]


def put_ok(port: int, lines: list[str], what: str) -> None:
    said = telnet(port, lines)
    if "put:" in said:
        fail(f"{what}: telnet puts answered {said[:300]!r}")


def reload_suffix(tsdb: TSDB, cycle: int, per_series: int) -> None:
    """One reload cycle's WAL suffix through the writer's add_batch:
    ``per_series`` points a telnet series, one a second from the cycle's
    first hour, values from a seed."""
    hours = -(-per_series // 3600)
    t0 = REPLICA_HOUR0 + (SUFFIX_HOUR0 + cycle * hours) * 3600
    ts = t0 + np.arange(per_series, dtype=np.int64)
    vals = (100 + np.random.default_rng(41 + cycle).normal(
        0, 5, (TELNET_SERIES, per_series))).astype(np.float32)
    for s in range(TELNET_SERIES):
        tsdb.add_batch("bench.metric", ts, vals[s].astype(np.float64),
                       {"host": f"t{s:02d}", "dc": f"dc{s % 10}"})


def hour_points(port: int, hour: int) -> int:
    """The buckets a daemon's /q answers over one added hour."""
    t0 = REPLICA_HOUR0 + hour * 3600
    _, ans = q_json(port, "zimsum:bench.metric", t0, t0 + 3599)
    return sum(len(g["dps"]) for g in ans)


def held_sketches(got: dict, want: dict, what: str) -> dict:
    """Every sketch route of the replica (``got``) answers the writer's
    (``want``) bytes."""
    for name, a in got.items():
        if a["body"] != want[name]["body"]:
            fail(f"{what}: replica /sketch {name} {a['body'][:200]!r}, "
                 f"writer {want[name]['body'][:200]!r}")
    return {name: {"replica_ms": a["wall_ms"],
                   "writer_ms": want[name]["wall_ms"]}
            for name, a in got.items()}


def replica_phase(tsdb: TSDB, daemon: "Daemon", wal: str,
                  ingest_rate: float) -> dict:
    """A replica over the restarted writer's store, in this process (ROADMAP
    item 10a): boot, first answers held against the writer's, tailing,
    a writer checkpoint and the sketch reloads, then failover; last each
    kernel call of the replica's path replayed against its plain
    version. Stops the writer's daemon."""
    out: dict = {}
    start, end = BASE, BASE + SPAN - 1
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    rtsdb = open_replica_tsdb(wal)
    out["boot_s"] = time.perf_counter() - t0
    out["boot_split_s"] = {
        "generations": rtsdb.store.open_seconds["generations"],
        "replay": rtsdb.store.open_seconds["replay"],
        "sketch_load": rtsdb.sketch_load_seconds}
    rdaemon, tailer = replica_daemon(rtsdb)
    calls: list = []
    try:
        # 1. First answers: the replica's scan path against the writer's
        # window, and every sketch route byte for byte. The tap keeps the
        # kernel calls of the replica daemon's threads.
        zero_launches()
        zero_sketch_launches()
        answers = {}
        with KernelTap() as tap:
            for expr, span in REPLICA_QUERIES:
                tap.label = f"{expr}, {'a day' if span == DAY else 'the week'}"
                wall, ans = q_json(rdaemon.port, expr, start,
                                   start + span - 1)
                if any(g["rollup"] != "raw" for g in ans):
                    fail(f"replica {expr}: plans "
                         f"{sorted({g['rollup'] for g in ans})}, not raw")
                answers[expr] = (wall, ans)
            sk_got = sketch_answers(rdaemon.port, start, end, tap)
        counts = dict(zip(KERNELS, launches()), **sketch_launches())
        calls += tap.of(pool_threads(rdaemon))
        tap.to_host()
        mine = tap_counts(calls)
        for name in REPLICA_QUERY_KERNELS + REPLICA_SKETCH_KERNELS:
            if counts[name] == 0 or mine[name] == 0:
                fail(f"the replica's queries never launched {name} (all "
                     f"threads {counts[name]}, the replica's {mine[name]})")
        out["launches_queries"] = counts
        out["replica_launches_queries"] = mine
        out["queries"] = {}
        for expr, span in REPLICA_QUERIES:
            wall_w, want = q_json(daemon.port, expr, start,
                                  start + span - 1)
            wall, got = answers[expr]
            out["queries"][expr] = {
                "replica_ms": wall, "writer_ms": wall_w,
                "writer_plan": want[0]["rollup"],
                "rel_diff_vs_writer": same_answer(expr, got, want, False)}
        out["sketch_at_boot"] = held_sketches(
            sk_got, sketch_answers(daemon.port, start, end), "at boot")
        log(f"replica boot {out['boot_s']:.2f} s {out['boot_split_s']}; "
            f"queries {out['queries']}; launches {counts}, the replica's "
            f"{mine}")

        # 2. Tailing: the telnet series' next TAIL_POINTS points into the
        # writer, then until the replica's /q holds all of them.
        out["healthz_before"] = http_json(rdaemon.port, "/healthz")
        lines = replica_put_lines(0, TAIL_POINTS // TELNET_SERIES)
        put_ok(daemon.port, lines, "the tail's puts")
        t0 = time.perf_counter()
        polls = 0
        while hour_points(rdaemon.port, 0) < len(lines):
            polls += 1
            if time.perf_counter() - t0 > 30:
                fail("the replica did not tail the writer's puts in 30 s")
            time.sleep(0.005)
        out["tail_lag_ms"] = (time.perf_counter() - t0) * 1e3
        out["tail_polls"] = polls
        out["healthz_after"] = http_json(rdaemon.port, "/healthz")
        if not out["healthz_after"]["ok"] or \
                out["healthz_after"]["refreshes"] <= \
                out["healthz_before"]["refreshes"]:
            fail(f"/healthz across the tail: {out['healthz_before']} -> "
                 f"{out['healthz_after']}")
        if hour_points(daemon.port, 0) != len(lines):
            fail("the writer does not hold the tail's puts")
        log(f"replica tail lag {out['tail_lag_ms']:.1f} ms ({polls} polls, "
            f"tail interval {tailer.interval_s} s)")

        # 3. A writer checkpoint: the replica's rebuild and sketch reload
        # (the tailer stopped, so they run here, timed apart), after which
        # every sketch route answers the writer's bytes.
        tailer.stop()
        rebuilds = rtsdb.store.rebuilds
        out["writer_checkpoint_s"] = timed_checkpoint(
            tsdb, "the writer's checkpoint under the replica")["seconds"]
        t0 = time.perf_counter()
        rtsdb.store.refresh()
        out["rebuild_ms"] = (time.perf_counter() - t0) * 1e3
        if rtsdb.store.rebuilds != rebuilds + 1:
            fail("the writer's checkpoint did not rebuild the replica")
        t0 = time.perf_counter()
        rtsdb.reload_sketches()
        out["reload_ms"] = (time.perf_counter() - t0) * 1e3
        out["sketch_after_checkpoint"] = held_sketches(
            sketch_answers(rdaemon.port, start, end),
            sketch_answers(daemon.port, start, end),
            "after the writer's checkpoint")
        # RELOADS more cycles: a few puts, a checkpoint, then the suffix
        # the writer ingests in one tail interval at the path phase's rate,
        # so each refresh_replica rebuilds and re-folds that suffix on the
        # card. The tap keeps the calls of the new sketch set's folder
        # thread and this thread. The card's allocated memory is read
        # around each refresh (the writer's folds drained first): the
        # replica's growth, which the replaced sketch set's freed stacks
        # must cancel; the replaced set's stacks must be gone and its
        # folder thread ended. The sketch routes are then held against the
        # writer's.
        per = max(1, round(ingest_rate * tailer.interval_s / TELNET_SERIES))
        out["reload_suffix_points"] = per * TELNET_SERIES
        out["reloads"] = []
        for i in range(RELOADS):
            put_ok(daemon.port, replica_put_lines(
                1 + i, RELOAD_POINTS // TELNET_SERIES),
                "a reload cycle's puts")
            tsdb.checkpoint()
            reload_suffix(tsdb, i, per)
            tsdb.sketches.flush()
            old = rtsdb.sketches
            stacks = [weakref.ref(t) for t in (
                old._td_means, old._td_weights, old._hll_regs)]
            folder = old._folder
            del old
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            zero_sketch_launches()
            with KernelTap() as tap:
                tap.label = f"reload {i + 1}"
                t0 = time.perf_counter()
                rtsdb.refresh_replica()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            sk = sketch_launches()
            mine = tap.of({rtsdb.sketches._folder, threading.current_thread()})
            tap.calls = mine
            tap.to_host()
            calls += mine
            mine = tap_counts(mine)
            for name in REPLICA_RELOAD_KERNELS:
                if sk[name] == 0 or mine[name] == 0:
                    fail(f"the replica's sketch reload {i} never launched "
                         f"{name} (all threads {sk[name]}, the replica's "
                         f"{mine[name]})")
            gc.collect()
            after = torch.cuda.memory_allocated()
            if any(r() is not None for r in stacks) or (
                    folder is not None and folder.is_alive()):
                fail(f"reload {i + 1} left the replaced sketch set's "
                     f"stacks or folder thread alive")
            held = held_sketches(sketch_answers(rdaemon.port, start, end),
                                 sketch_answers(daemon.port, start, end),
                                 f"after reload {i + 1}")
            out["reloads"].append({
                "refresh_replica_ms": wall, "launches": sk,
                "replica_launches": mine,
                "fold_calls": rtsdb.sketches.fold_calls,
                "sketches": held, "memory_before": before,
                "memory_after": after})
        growth = [r["memory_after"] - r["memory_before"]
                  for r in out["reloads"]]
        out["reload_memory_delta_bytes"] = sum(growth)
        if abs(sum(growth)) > RELOAD_MEMORY_SLACK:
            fail(f"card memory across {RELOADS} sketch reloads grew by "
                 f"{growth} bytes")
        # The replica path's launches: its queries' and its reloads'.
        out["launches"] = {
            name: n + sum(r["launches"].get(name, 0) for r in out["reloads"])
            for name, n in out["launches_queries"].items()}
        out["replica_launches"] = tap_counts(calls)
        log(f"replica rebuild {out['rebuild_ms']:.1f} ms, reload "
            f"{out['reload_ms']:.1f} ms; suffix "
            f"{out['reload_suffix_points']} points; reloads "
            f"{out['reloads']}")

        # 4. Failover: the writer stops, the epoch file is bumped, and the
        # replica takes the store over (its WAL then begins with its
        # epoch's header) and ingests.
        t0 = time.perf_counter()
        daemon.stop()
        out["writer_stop_s"] = time.perf_counter() - t0
        epath = cepoch.epoch_path_for_wal(wal)
        epoch = cepoch.bump_epoch(epath, "smoke-replica")
        rdaemon.server.tailer = None
        t0 = time.perf_counter()
        rtsdb.promote(epoch, epoch_guard=cepoch.EpochGuard(
            epath, epoch, interval_s=rtsdb.config.epoch_check_interval_s))
        out["promotion_s"] = time.perf_counter() - t0
        out["promotion_split_s"] = dict(rtsdb.promote_seconds)
        rtsdb.config.role = "writer"
        if rtsdb.store.read_only or rtsdb.tenants is None:
            fail("the promoted replica is not a writer")
        with open(wal, "rb") as f:
            op, plen = port_kv._REC.unpack(f.read(port_kv._REC.size))
            head = f.read(plen)
        if op != port_kv._OP_EPOCH or int.from_bytes(head[4:], "big") \
                != epoch:
            fail(f"the promoted WAL begins with op {op}, not epoch {epoch}")
        lines = replica_put_lines(PROMOTED_HOUR,
                                  TAIL_POINTS // TELNET_SERIES)
        put_ok(rdaemon.port, lines, "puts into the promoted replica")
        got = hour_points(rdaemon.port, PROMOTED_HOUR)
        if got != len(lines):
            fail(f"the promoted replica answers {got} of {len(lines)} "
                 f"points")
        out["promoted"] = {"epoch": epoch, "wal_header_epoch": epoch,
                           "points_answered": got}
        log(f"promotion {out['promotion_s']:.2f} s "
            f"{out['promotion_split_s']}; {out['promoted']}")
    finally:
        tailer.stop()
        rdaemon.stop()
    out["phase_s"] = time.perf_counter() - t_phase
    # Each kernel call of the replica's path, at the shape the path gave
    # it, against its plain version; the largest of each kernel timed.
    out["kernel_cases"], out["kernel_checks"] = replica_kernel_cases(
        calls, "replica")
    missing = set(REPLICA_KERNELS) - {r["name"] for r in out["kernel_cases"]}
    if missing:
        fail(f"no replica call of {sorted(missing)} to replay")
    log(f"replica kernel checks: {out['kernel_checks']}")
    return out


# ---------------------------------------------------------------------------
# Router phase: the storage-free front door over the card's replicas
# ---------------------------------------------------------------------------

# The router's hop options (no hedging but in the hedge check, quick
# probes) and the promotion grace of the failover leg. A backend is
# ejected only after 50 failed probes (10 s), so the owner whose listener
# the retry check stops is still in rotation when the routed query comes
# and the router must retry around it.
ROUTER_ARGS = ("--probe-interval", "0.2", "--router-eject-after", "50",
               "--router-retries", "2", "--router-deadline-ms", "120000")
WRITER_GRACE_MS = 1000.0
# Runs of the cheapest query direct and through the router (hop overhead).
HOP_REPS = 5
# The router leg's puts: an hour of the telnet series well past the week
# and past every hour the replica phase writes.
ROUTER_HOUR = 48


def start_router(*args: str) -> tuple:
    """``tsdb tsd --role router`` as its own process, under ``python -X
    importtime`` (every module it imports, on its standard error, which
    ``router_imports`` checks once the router is up): the process, its
    port, its boot seconds (spawn to the ready line) and its imports."""
    fd, err_path = tempfile.mkstemp(suffix=".router.err")
    try:
        t0 = time.perf_counter()
        with os.fdopen(fd, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-X", "importtime", "-m",
                 "opentsdb_tpu_torch.tools.cli", "tsd", "--role", "router",
                 "--port", "0", "--bind", "127.0.0.1", *args],
                stdout=subprocess.PIPE, stderr=err, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)))
        line = proc.stdout.readline()
        boot_s = time.perf_counter() - t0
        if not line.startswith("Ready to serve on "):
            stop_router(proc)
            with open(err_path) as f:
                fail(f"the router did not come up: {line!r} "
                     f"{f.read()[-2000:]}")
        try:
            imports = router_imports(err_path)
        except BaseException:
            stop_router(proc)
            raise
    finally:
        os.unlink(err_path)
    return proc, int(line.strip().rsplit(":", 1)[1]), boot_s, imports


def stop_router(proc) -> int:
    """SIGTERM, as an operator stops it; its exit code."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    proc.stdout.close()
    return proc.returncode


def router_imports(err_path: str) -> dict:
    """What the router process imported (its ``-X importtime`` lines): the
    count, and any module of torch, jax, the storage engine, the core or
    the daemon, which fails the smoke."""
    names = []
    with open(err_path) as f:
        for ln in f:
            if ln.startswith("import time:") and "|" in ln:
                name = ln.rsplit("|", 1)[1].strip()
                if name != "package":
                    names.append(name)
    banned = sorted(n for n in names if n.split(".")[0] in (
        "torch", "jax", "jaxlib", "opentsdb_tpu") or n.startswith((
            "opentsdb_tpu_torch.core", "opentsdb_tpu_torch.storage",
            "opentsdb_tpu_torch.server", "opentsdb_tpu_torch.ops")))
    if banned or "opentsdb_tpu_torch.serve.router" not in names:
        fail(f"the router process imported {banned[:20]} (router module "
             f"seen: {'opentsdb_tpu_torch.serve.router' in names})")
    return {"modules": len(names), "torch": False, "jax": False}


def on_loop(daemon: "Daemon", coro_fn) -> object:
    """Run ``coro_fn()`` on the daemon's event loop; its result."""
    return asyncio.run_coroutine_threadsafe(coro_fn(), daemon.loop).result(60)


def stop_listener(daemon: "Daemon") -> int:
    """Close the daemon's listening socket (the process, its TSDB and its
    event loop stay up: a writer or a replica that stops answering); its
    port."""
    port = daemon.port

    async def close():
        daemon.server._server.close()
        await daemon.server._server.wait_closed()
    on_loop(daemon, close)
    return port


def restart_listener(daemon: "Daemon", port: int) -> None:
    async def listen():
        daemon.server._server = await asyncio.start_server(
            daemon.server._handle_conn, "127.0.0.1", port)
    on_loop(daemon, listen)


def router_counters(port: int) -> dict:
    return http_json(port, "/api/topology")["counters"]


def idle_pools(*daemons) -> None:
    """Wait until the daemons answer no /q (a hedge's loser included)."""
    t0 = time.perf_counter()
    while any(d.server.admission.inflight_queries for d in daemons):
        if time.perf_counter() - t0 > 120:
            fail("a replica still runs a routed query after 120 s")
        time.sleep(0.01)


def router_phase(tsdb: TSDB, daemon: "Daemon", wal: str) -> dict:
    """The fan-out leg (ROADMAP item 10b, 5g of the module docstring): two
    replicas of the restarted store on the card, each with its tailer and
    daemon, and in front of them a router process over both, forwarding
    puts to the writer's daemon. Stops both replicas and the router."""
    out: dict = {}
    start = BASE
    t_phase = time.perf_counter()
    reps = []
    routers = []
    calls: list = []
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            rtsdb = open_replica_tsdb(wal)
            reps.append((rtsdb, *replica_daemon(rtsdb)))
            out.setdefault("replica_boot_s", []).append(
                time.perf_counter() - t0)
        (_, ra, _), (_, rb, _) = reps[0], reps[1]
        backends = ",".join(f"http://127.0.0.1:{d.port}" for d in (ra, rb))
        writer_url = f"http://127.0.0.1:{daemon.port}"
        proc, rport, boot_s, out["router_imports"] = start_router(
            "--backends", backends, "--writer-url", writer_url,
            "--router-hedge-ms", "-1", *ROUTER_ARGS)
        routers.append(proc)
        out["router_boot_s"] = boot_s
        # A second router whose hops hedge after 1 ms.
        proc2, hport, _, _ = start_router(
            "--backends", backends, "--router-hedge-ms", "1", *ROUTER_ARGS)
        routers.append(proc2)
        owner = {expr: [ra, rb][port_router_owner(expr, 2)]
                 for expr, _ in REPLICA_QUERIES}
        # 1. Outside the counted window: each query's owner replica's own
        # answer, then the hop's overhead on the cheapest query, warm,
        # direct and through the router in turns.
        direct = {}
        for expr, span in REPLICA_QUERIES:
            direct[expr] = q_body(owner[expr].port, expr, start,
                                  start + span - 1)
        expr, span = REPLICA_QUERIES[2]
        end = start + span - 1
        direct_ms, router_ms = [], []
        for _ in range(HOP_REPS):
            direct_ms.append(q_body(owner[expr].port, expr, start, end)[0])
            router_ms.append(q_body(rport, expr, start, end)[0])
        out["hop"] = {"query": expr, "direct_ms": direct_ms,
                      "router_ms": router_ms,
                      "overhead_ms": statistics.median(router_ms)
                      - statistics.median(direct_ms)}
        # 2. The counted window holds routed requests only: the counts are
        # set to 0 just before the first and read just after the last, and
        # the tap records what the replicas' threads launched for each.
        routed_labels = []
        zero_launches()
        with KernelTap() as tap:
            out["queries"] = {}
            for q_expr, q_span in REPLICA_QUERIES:
                tap.label = f"{q_expr} via the router"
                routed_labels.append(tap.label)
                wall_r, routed = q_body(rport, q_expr, start,
                                        start + q_span - 1)
                wall_d, body_d = direct[q_expr]
                out["queries"][q_expr] = {
                    "owner": "a" if owner[q_expr] is ra else "b",
                    "direct_ms": wall_d, "router_ms": wall_r,
                    "identical": routed == body_d,
                    "rel_diff_vs_owner": same_answer(
                        q_expr, json.loads(routed), json.loads(body_d),
                        q_expr.startswith(("max", "p")))}
            # A retry: the owner's listener stops, the hop retries on the
            # other replica and still answers.
            c0 = router_counters(rport)
            down = owner[expr]
            port = stop_listener(down)
            tap.label = f"{expr}, its owner's listener stopped"
            routed_labels.append(tap.label)
            try:
                wall, routed = q_body(rport, expr, start, end)
            finally:
                restart_listener(down, port)
            c1 = router_counters(rport)
            if c1["retries"] <= c0["retries"]:
                fail(f"no retry counted around the stopped replica: {c1}")
            out["retry"] = {"ms": wall, "retries": c1["retries"]
                            - c0["retries"], "rel_diff_vs_owner":
                            same_answer(expr, json.loads(routed),
                                        json.loads(direct[expr][1]), True)}
            # A hedge, through the second router.
            tap.label = f"{expr} hedged"
            routed_labels.append(tap.label)
            wall, hedged = q_body(hport, expr, start, end)
            h = router_counters(hport)
            idle_pools(ra, rb)
            counts = path_launches("router path", REPLICA_QUERY_KERNELS)
        if h["hedges"] < 1:
            fail(f"the hedged router recorded no hedge: {h}")
        out["hedge"] = {"ms": wall, "hedges": h["hedges"],
                        "hedge_wins": h["hedge_wins"],
                        "rel_diff_vs_owner": same_answer(
                            expr, json.loads(hedged),
                            json.loads(direct[expr][1]), True)}
        calls = tap.of(pool_threads(ra) | pool_threads(rb))
        tap.calls = calls
        tap.to_host()
        # Every routed request launched kernels on a replica's threads,
        # and every kernel of the path launched for one. (A call's own
        # count is its wrapper's count across the call, which the other
        # replica's concurrent calls also raise during the hedge: the
        # path's count is the one read above.)
        for label in routed_labels:
            if not any(c.label == label and c.launched for c in calls):
                fail(f"no replica thread launched a kernel for {label!r}")
        for name in REPLICA_QUERY_KERNELS:
            if not any(c.name == name and c.launched for c in calls):
                fail(f"no replica thread launched {name} for a routed "
                     f"request ({counts[name]} launches in all)")
        out["launches"] = counts
        # 3. A put through the router's telnet reaches the writer, and the
        # router answers it back.
        lines = replica_put_lines(ROUTER_HOUR, 1)
        put_ok(rport, lines, "puts through the router")
        t0 = time.perf_counter()
        while hour_points(rport, ROUTER_HOUR) < len(lines):
            if time.perf_counter() - t0 > 30:
                fail("the router's put never came back through the router")
            time.sleep(0.01)
        out["put"] = {"points": len(lines),
                      "read_back_ms": (time.perf_counter() - t0) * 1e3,
                      "writer_points": hour_points(daemon.port,
                                                   ROUTER_HOUR)}
        if out["put"]["writer_points"] != len(lines):
            fail(f"the writer holds {out['put']['writer_points']} of the "
                 f"router's {len(lines)} puts")
        out["router_healthz"] = http_json(rport, "/healthz")
        out["router_exit"] = [stop_router(p) for p in routers]
        if any(out["router_exit"]):
            fail(f"a router exited {out['router_exit']} on SIGTERM")
    finally:
        for p in routers:
            stop_router(p)
        for rtsdb, rdaemon, tailer in reps:
            tailer.stop()
            rdaemon.stop()
    out["phase_s"] = time.perf_counter() - t_phase
    out["kernel_cases"], out["kernel_checks"] = replica_kernel_cases(
        calls, "router")
    log(f"router phase: {({k: v for k, v in out.items() if k not in ('kernel_cases', 'kernel_checks')})}")
    return out


def port_router_owner(expr: str, n: int) -> int:
    """The backend index the router sends ``expr`` to (its ownership hash,
    ``serve/router.series_hash``)."""
    from opentsdb_tpu_torch.serve.router import series_hash
    return series_hash(expr.encode()) % n


def failover_leg(wal: str, start: int, end: int) -> dict:
    """The degraded and failover leg (5g of the module docstring), over the
    rollup child's store: a ``--cluster`` writer, one replica and a router
    process driving promotion."""
    out: dict = {}
    t_leg = time.perf_counter()
    cfg = Config(auto_create_metrics=True, port=0, bind="127.0.0.1",
                 device=DEVICE, device_window=False, enable_rollups=True,
                 cluster=True, cluster_owner="smoke-writer")
    wtsdb = port_cli.make_tsdb(cfg, wal)
    tune_for_ingest()
    wd = Daemon(wtsdb)
    rtsdb = open_replica_tsdb(wal, enable_rollups=True, cluster=True,
                              cluster_owner="smoke-replica")
    rd, tailer = replica_daemon(rtsdb)
    proc = None
    try:
        out["writer_epoch"] = wtsdb.store.writer_epoch
        if not rtsdb.rollups or not rtsdb.rollups.ready:
            fail("the cluster replica has no ready rollup tier")
        proc, rport, out["router_boot_s"], out["router_imports"] = \
            start_router(
                "--backends", f"http://127.0.0.1:{rd.port}", "--writer-url",
                f"http://127.0.0.1:{wd.port}", "--writer-grace-ms",
                str(WRITER_GRACE_MS), "--router-hedge-ms", "-1",
                *ROUTER_ARGS)
        # 1. The degraded step through the router: a percentile from the
        # replica's sketch columns within its bound of the writer's exact
        # answer; a raw-only query 503.
        expr = "max:1h-p95:bench.metric"
        q = urllib.parse.urlencode({"start": start, "end": end, "m": expr,
                                    "json": ""})
        q0 = time.perf_counter()
        status, exact = http_get(wd.port, "/q?" + q)
        exact_ms = (time.perf_counter() - q0) * 1e3
        if status != 200:
            fail(f"the writer's exact {expr}: {status} {exact[:300]!r}")
        exact_dps = {}
        for ent in json.loads(exact):
            exact_dps.update(ent["dps"])
        conn = http.client.HTTPConnection("127.0.0.1", rport, timeout=600)
        q0 = time.perf_counter()
        conn.request("GET", "/q?" + q + "&degrade=rollup-only")
        resp = conn.getresponse()
        body = resp.read()
        deg_ms = (time.perf_counter() - q0) * 1e3
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
        conn.close()
        if resp.status != 200 or "rollup-only" not in hdrs.get(
                "x-tsd-degraded", "") or not hdrs.get("x-tsd-approx"):
            fail(f"degraded {expr}: {resp.status} {hdrs} {body[:300]!r}")
        buckets, worst = 0, 0.0
        for ent in json.loads(body):
            ap = ent.get("approx") or {}
            if "rollup-only" not in ent.get("degraded", "") or ap.get(
                    "kind") not in ("tdigest", "moment") or not isinstance(
                    ap.get("error"), float):
                fail(f"degraded {expr}: a result without its tag or bound: "
                     f"{ent.get('degraded')} {ap}")
            for ts_s, v in ent["dps"].items():
                buckets += 1
                if ts_s not in exact_dps:
                    fail(f"degraded {expr}: bucket {ts_s} not in the exact "
                         f"answer")
                diff = abs(exact_dps[ts_s] - v)
                if diff > ap["error"] + 1e-9:
                    fail(f"degraded {expr}: bound violated at {ts_s}: "
                         f"{v} vs {exact_dps[ts_s]}, error {ap['error']}")
                worst = max(worst, diff)
        if not buckets:
            fail(f"degraded {expr}: no bucket")
        raw = urllib.parse.urlencode({"start": start, "end": end,
                                      "m": "sum:bench.metric", "json": "",
                                      "degrade": "rollup-only"})
        conn = http.client.HTTPConnection("127.0.0.1", rport, timeout=600)
        conn.request("GET", "/q?" + raw)
        resp = conn.getresponse()
        shed = (resp.status, resp.getheader("Retry-After"), resp.read())
        conn.close()
        if shed[0] != 503 or not shed[1]:
            fail(f"the raw-only degraded query: {shed}")
        out["degraded"] = {"query": expr, "exact_ms": exact_ms,
                           "degraded_ms": deg_ms, "buckets": buckets,
                           "x_tsd_approx": hdrs["x-tsd-approx"],
                           "x_tsd_degraded": hdrs["x-tsd-degraded"],
                           "max_abs_diff": worst,
                           "bounds": sorted({e["approx"]["error"] for e in
                                             json.loads(body)}),
                           "raw_only": {"status": shed[0],
                                        "retry_after": shed[1]}}
        # 2. Failover: the writer's listener stops; the router promotes
        # the replica after the grace, flips its forwarding, and a put
        # through it is answered by the promoted daemon.
        t_stop = time.perf_counter()
        wport = stop_listener(wd)
        promoted = None
        while promoted is None:
            if time.perf_counter() - t_stop > 60:
                fail("the router did not promote the replica in 60 s")
            time.sleep(0.02)
            promo = http_json(rport, "/api/topology")["promotion"]
            promoted = next((e for e in promo["events"]
                             if e["event"] == "promoted"), None)
        t_promoted = time.perf_counter()
        if rtsdb.store.read_only or promoted["url"] != \
                f"http://127.0.0.1:{rd.port}":
            fail(f"promotion: {promoted}, replica read-only "
                 f"{rtsdb.store.read_only}")
        t_put = BASE + SPAN + 3600
        line = f"put bench.metric {t_put} 42.5 host=h00000 dc=dc0"
        target = "/q?" + urllib.parse.urlencode(
            {"start": t_put - 60, "end": t_put + 60,
             "m": "sum:bench.metric{host=h00000}", "json": ""})
        while True:
            said = telnet(rport, [line])
            if "put:" not in said:
                status, body = http_get(rport, target)
                if status == 200 and any(str(t_put) in e["dps"]
                                         for e in json.loads(body)):
                    break
            if time.perf_counter() - t_stop > 90:
                fail(f"no put acked through the router after the "
                     f"promotion: {said!r}")
            time.sleep(0.05)
        t_acked = time.perf_counter()
        out["failover"] = {
            "grace_ms": WRITER_GRACE_MS,
            "stop_to_promoted_s": t_promoted - t_stop,
            "stop_to_first_acked_put_s": t_acked - t_stop,
            "promoted_epoch": promoted["epoch"],
            "promote_split_s": dict(rtsdb.promote_seconds)}
        # 3. The old writer returns on its port: fenced, then demoted by
        # the router, then tailing the promoted writer's WAL.
        try:
            wtsdb.add_point("bench.metric", t_put + 60, 1.0,
                            {"host": "h00000", "dc": "dc0"})
            fail("the deposed writer took a put")
        except FencedWriterError:
            pass
        t0 = time.perf_counter()
        restart_listener(wd, wport)
        while not (wtsdb.store.read_only and wd.server.tailer is not None):
            if time.perf_counter() - t0 > 60:
                fail("the router never demoted the returning writer")
            time.sleep(0.02)
        out["demote_s"] = time.perf_counter() - t0
        while True:
            status, body = http_get(wd.port, target)
            if status == 200 and any(str(t_put) in e["dps"]
                                     for e in json.loads(body)):
                break
            if time.perf_counter() - t0 > 60:
                fail("the demoted writer never tailed the promoted one")
            time.sleep(0.05)
        out["demoted_tails_s"] = time.perf_counter() - t0
        out["events"] = [e["event"] for e in http_json(
            rport, "/api/topology")["promotion"]["events"]]
        if out["events"][-2:] != ["promoted", "demoted"]:
            fail(f"the router's failover events: {out['events']}")
        out["router_exit"] = stop_router(proc)
        if out["router_exit"]:
            fail(f"the router exited {out['router_exit']} on SIGTERM")
    finally:
        if proc is not None:
            stop_router(proc)
        tailer.stop()
        wd.stop()
        rd.stop()
    out["leg_s"] = time.perf_counter() - t_leg
    log(f"failover leg: {out}")
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
            out["replica"] = replica_check(daemon, root, [
                (REPLICA_QUERIES[0][0], start, start + DAY - 1)])
        finally:
            daemon.stop()
    return out


def group_sum_runs(calls: list) -> list:
    """For each recorded segment_sum call, how many different outputs
    GROUP_SUM_REPEATS runs on its input give (float32 sums added by
    atomics in a run-dependent order)."""
    dev = torch.device(DEVICE)
    out = []
    for c in calls:
        if c.name != "segment_sum":
            continue
        a = tap_copy(c.args, lambda t: t.to(dev))
        seen = {segment_reduce.segment_sum(
            a["feat"], a["seg"], a["num_segments"]).cpu().numpy().tobytes()
            for _ in range(GROUP_SUM_REPEATS)}
        out.append(len(seen))
    return out


def replica_check(daemon: "Daemon", wal: str, queries: list,
                  plans: dict | None = None) -> dict:
    """A replica daemon over ``wal`` beside the writer's ``daemon``: its
    boot, and each (expr, start, end) of ``queries`` held against the
    writer's answer (tags and timestamps equal, max and percentiles
    exactly, sums by the resident tolerance), for a query ``plans``
    names (the rollup tier's) served with that plan by both; the
    writer's window, where it has one, answers from other inputs.
    ``identical`` says whether the bodies are the same bytes. Where a
    planned query's bodies differ, the kernel calls of the two queries
    must have had the same inputs, bit for bit (``same_inputs``: so the
    replica read what the writer reads, and only the card's order of
    addition differs), and ``group_sum_outputs`` gives, for each of the
    writer's segment_sum calls, the different outputs of
    GROUP_SUM_REPEATS runs on its input."""
    t0 = time.perf_counter()
    rtsdb = open_replica_tsdb(wal, enable_rollups=bool(plans))
    out: dict = {"boot_s": time.perf_counter() - t0, "queries": {}}
    rdaemon, tailer = replica_daemon(rtsdb)
    try:
        for expr, start, end in queries:
            with KernelTap() as tap:
                wall, got = q_body(rdaemon.port, expr, start, end)
                _, want = q_body(daemon.port, expr, start, end)
            plan = (plans or {}).get(expr)
            ga, wa = json.loads(got), json.loads(want)
            if plan is not None and {g["rollup"] for g in ga + wa} != {plan}:
                fail(f"replica {expr}: plans {ga[0]['rollup']} / writer "
                     f"{wa[0]['rollup']}, not {plan}")
            exact = plan is not None and expr.startswith(("max", "p"))
            rec = {"replica_ms": wall, "replica_plan": ga[0]["rollup"],
                   "writer_plan": wa[0]["rollup"], "identical": got == want,
                   "rel_diff_vs_writer": same_answer(expr, ga, wa, exact)}
            if plan is not None and got != want:
                mine = tap.of(pool_threads(rdaemon))
                theirs = tap.of(pool_threads(daemon))
                rec["same_inputs"] = len(mine) == len(theirs) and all(
                    (a.name, a.entry) == (b.name, b.entry)
                    and same_arg_bits(a.args, b.args)
                    for a, b in zip(mine, theirs))
                if not rec["same_inputs"]:
                    fail(f"replica {expr}: other bytes than the writer's, "
                         f"from other kernel inputs")
                rec["group_sum_outputs"] = group_sum_runs(theirs)
            out["queries"][expr] = rec
    finally:
        tailer.stop()
        rdaemon.stop()
    log(f"replica of {wal}: {out}")
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
# kernels it launched, the memsets it made and the wrapper's own launch
# count. A profile that recorded no device event at all while the
# wrapper launched (CUPTI lost the records, as FOLD_COUNT's can) is
# taken again, up to PROFILES times.
DECODE_COUNT = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from opentsdb_tpu_torch.ops import block_decode
from opentsdb_tpu_torch.tools.compare_kernels import decode_inputs
PROFILES = 5


def profiled(args, vkind):
    before = block_decode.decode_points.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        block_decode.decode_points(*args, vkind=vkind)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    memsets = [n for n in names if "memset" in n.lower()]
    kernels = [n for n in names
               if n not in memsets and "memcpy" not in n.lower()]
    return kernels, memsets, block_decode.decode_points.launches - before


for n, vkind in zip(sys.argv[1::2], sys.argv[2::2]):
    args = decode_inputs(torch.device("cuda"), int(n), seed=5)
    block_decode.decode_points(*args, vkind=vkind)
    torch.cuda.synchronize()
    for taken in range(1, PROFILES + 1):
        kernels, memsets, launched = profiled(args, vkind)
        if kernels or memsets or launched != 1:
            break
    print(json.dumps({"kernels_per_call": len(kernels),
                      "memsets_per_call": len(memsets),
                      "kernel_names": sorted(set(kernels)),
                      "wrapper_launches": launched, "profiles": taken}))
    del args
"""


def count_decode_kernels(cases: list) -> None:
    """Each decode case's kernels and memsets in one call, counted under
    torch.profiler in a child process on a gather of the case's size and
    kind (compare_kernels' decode_inputs; the count does not depend on
    the data): at most DECODE_MAX_KERNELS kernels, no memset and one
    wrapper launch. In this process, right after the plain version's run,
    the profiler has shown no device activity at all for one decode on
    the card, while a fresh process records both kernels; a fresh
    process lost every record of one call once too, so a profile with no
    device event is taken again."""
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
                or c["memsets_per_call"] or c["wrapper_launches"] != 1:
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


FUSED_MESH_D = 4
# The mesh leg's kernels: each shard's decode and segment folds, the one
# combine.
FUSED_MESH_KERNELS = ("block_decode", "segment_sum", "segment_minmax",
                      "moment_combine")
FUSED_MESH_WHERE = {"source": "opentsdb_tpu_torch/compress/kernels.py",
                    "replaces": "opentsdb_tpu/compress/kernels.py:139"}


def fused_mesh_launches() -> dict:
    return {"block_decode": block_decode.decode_points.launches,
            "segment_sum": segment_reduce.segment_sum.launches,
            "segment_minmax": segment_reduce.segment_minmax.launches,
            "moment_combine": mesh_combine.moment_combine.launches}


def zero_fused_mesh_launches() -> None:
    zero_decode_launches()
    mesh_combine.moment_combine.launches = 0


def json_answer(results: list, plan: str) -> list:
    """Executor results in the daemon's /q JSON shape."""
    return json.loads(json.dumps(TSDServer._json_output(
        results, [plan] * len(results), [False] * len(results))))


@contextlib.contextmanager
def plain_fused_mesh():
    """The mesh leg's body with every kernel replaced by its plain
    version (the body's plain version, for timing beside it)."""
    saved = (ckernels.decode_points, wk.segment_sum, wk.segment_minmax,
             mesh_combine.moment_combine)
    ckernels.decode_points = block_decode.decode_points_plain
    wk.segment_sum = segment_reduce.segment_sum_plain
    wk.segment_minmax = segment_reduce.segment_minmax_plain
    mesh_combine.moment_combine = (
        lambda *a, agg: mesh_combine.moment_combine_plain(*a, agg))
    try:
        yield
    finally:
        (ckernels.decode_points, wk.segment_sum, wk.segment_minmax,
         mesh_combine.moment_combine) = saved


def fused_mesh_body_case(tsdb: TSDB, mesh: Mesh, start: int,
                         end: int) -> dict:
    """The mesh leg's whole body at the week's full gather (sum:1h-avg's
    stage: every series, 1 h buckets), its shards on the card: held
    against its plain version (masks identical, count-derived grids
    exact, values within the resident tolerance) and timed like a kernel.
    Bound: bytes (each shard stream read once, the five stage grids
    written once)."""
    dev = torch.device(DEVICE)
    uid = tsdb.metrics.get_id("bench.metric")
    src = cfused.gather(tsdb.store, tsdb.table, uid, BASE,
                        end - end % INTERVAL)
    S_pad = _pad_size(len(src.series_keys))
    B = _pad_size((end - BASE) // INTERVAL + 1)
    streams, counts = cfused.block_shards(
        src.ts_nb, src.ts_pay, src.v_nb, src.v_pay, src.first_idx,
        src.blk_first, src.rel_base_pt, np.minimum(src.sid_pt, S_pad - 1),
        src.valid, mesh.size, pad_fine)
    args = [torch.from_numpy(a).to(dev) for a in streams]
    qbase = start - start % INTERVAL
    tail = (start - src.epoch, end - src.epoch, qbase - src.epoch, 0.0,
            0.0)
    fn = ckernels.fused_block_stage_mesh(
        mesh, num_series=S_pad, num_buckets=B, interval=INTERVAL,
        agg_down="avg", rate=False, counter=False, drop_resets=False,
        vkind=src.kind)

    def run():
        return fn(*args, *tail)

    def plain():
        with plain_fused_mesh():
            return fn(*args, *tail)

    zero_fused_mesh_launches()
    got = run()
    torch.cuda.synchronize()
    per_call = fused_mesh_launches()
    want = plain()
    for i, name in enumerate(("series_mask", "in_range", "presence")):
        if not torch.equal(got[(1, 3, 4)[i]], want[(1, 3, 4)[i]]):
            fail(f"fused mesh body: {name} differs from its plain version")
    sv = torch.where(got[1], got[0], 0.0).double()
    pv = torch.where(want[1], want[0], 0.0).double()
    scale = float(pv.abs().max())
    err = float((sv - pv).abs().max())
    if not bool(((sv - pv).abs() <= 1e-5 * pv.abs() + 1e-5 * scale).all()):
        fail(f"fused mesh body: values off its plain version by {err}")
    nbytes = sum(a.numel() * a.element_size() for a in args) \
        + S_pad * B * 10 + S_pad
    b_ms, b_by = bound_ms(nbytes, 0)
    res = {"name": "fused_block_stage_mesh", "stage": "week gather "
           "(TSF32), sum:1h-avg's stage", "D": mesh.size,
           "points": src.npoints, "shard_points": counts,
           "padded_points": int(streams[0].shape[1]),
           "series": S_pad, "buckets": B, "launches_per_call": per_call,
           "bytes": nbytes, "max_abs_err": err, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None, "library": NO_LIBRARY,
           "ms": median_ms(run, reps=10),
           "ms_device": device_ms(run, reps=10),
           "plain_ms": median_ms(plain, reps=3)}
    res["share"] = res["bound_ms"] / res["ms_device"]
    del args, got, want
    torch.cuda.empty_cache()
    log(f"fused mesh body: {res}")
    return res


def fused_mesh_phase(tsdb: TSDB, answers: dict, start: int,
                     end: int) -> dict:
    """The fused plan's mesh leg: a second in-process executor over the
    compressed store with a mesh of FUSED_MESH_D logical shards of the
    card. The ten queries cold (launches of the leg counted, every
    moment_combine payload kept and held bit for bit against its plain
    version) and warm, each against the daemon's single-device fused
    answer and REFERENCE (the resident tolerance, max exact); each cut's
    point count a shard; the body timed (fused_mesh_body_case); one query
    at D = 3 counts mesh-indivisible and serves fused on one device."""
    t_phase = time.perf_counter()
    mesh = Mesh([f"{DEVICE}:0"] * FUSED_MESH_D)
    ex = QueryExecutor(tsdb, mesh=mesh)
    out: dict = {"D": FUSED_MESH_D, "queries": {}}
    calls: list = []
    restore = mesh_tap(calls)
    zero_fused_mesh_launches()
    d0 = mesh_plane._M_DISPATCH.count
    cold: dict = {}
    try:
        for expr in QUERIES + PCT_QUERIES:
            ex.fused_shard_points = None
            t0 = time.perf_counter()
            res, plan, _ = ex.run_with_plan(spec_of(expr), start, end)
            cold[expr] = ((time.perf_counter() - t0) * 1e3, res, plan,
                          ex.fused_shard_points)
    finally:
        restore()
    out["launches"] = fused_mesh_launches()
    out["dispatches"] = mesh_plane._M_DISPATCH.count - d0
    for k in FUSED_MESH_KERNELS:
        if out["launches"][k] == 0:
            fail(f"the fused mesh leg never launched {k}")
    if out["dispatches"] < 1:
        fail("the fused mesh leg made no mesh dispatch")
    checks = mesh_checks(calls)
    out["moment_combine_checks"] = {
        "calls": len(checks),
        "bit_equal": all(c["bit_equal"] for c in checks),
        "shapes": sorted({(c["arg"], c["D"], c["size"]) for c in checks})}
    del calls
    for expr in QUERIES + PCT_QUERIES:
        ms, res, plan, shard_points = cold[expr]
        if plan != "fused":
            fail(f"fused mesh {expr}: plan {plan}")
        got = json_answer(res, plan)
        warm = []
        for _ in range(FUSED_WARM_REPS):
            t0 = time.perf_counter()
            again, plan2, _ = ex.run_with_plan(spec_of(expr), start, end)
            warm.append((time.perf_counter() - t0) * 1e3)
            if plan2 != "fused":
                fail(f"fused mesh {expr}: warm plan {plan2}")
            # The group stage's float32 sums run again on every query,
            # in an order the card does not fix.
            same_answer(expr, json_answer(again, plan2), got,
                        expr.startswith("max"))
        exact = expr.startswith("max")
        out["queries"][expr] = {
            "first_ms": ms, "warm_ms": warm, "shard_points": shard_points,
            "single_device_max_rel_diff": same_answer(
                expr, got, answers[expr], exact),
            "resident_max_rel_diff": same_answer(
                expr, got, REFERENCE["resident"][expr], False)}
        log(f"fused mesh {expr}: {out['queries'][expr]}")
    out["body"] = fused_mesh_body_case(tsdb, mesh, start, end)
    # D = 3: the week's padded stream (10,485,760 points) is not a
    # multiple of 3.
    ex3 = QueryExecutor(tsdb, mesh=Mesh([f"{DEVICE}:0"] * 3))
    d0 = decline_count("mesh-indivisible")
    expr = QUERIES[0]
    res, plan, _ = ex3.run_with_plan(spec_of(expr), start, end)
    if plan != "fused" or decline_count("mesh-indivisible") != d0 + 1:
        fail(f"D = 3: plan {plan}, mesh-indivisible "
             f"{decline_count('mesh-indivisible') - d0}")
    out["indivisible"] = {
        "D": 3, "query": expr, "plan": plan, "declined": "mesh-indivisible",
        "max_rel_diff": same_answer(expr, json_answer(res, plan),
                                    answers[expr], False)}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"fused mesh leg: {out['launches']}, {out['dispatches']} "
        f"dispatches, {out['phase_s']:.1f} s")
    return out


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
            out["fused_mesh"] = fused_mesh_phase(tsdb, answers, start, end)
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


CLI_SERIES = 100              # the cli line's import: 100 x 1,000 lines
CLI_QUERY = "max:1h-max:bench.metric{host=*}"


def run_cli(*argv: str) -> tuple[int, str, float]:
    """``tsdb <argv>`` in this process: (exit code, stdout, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = port_cli.main(list(argv))
    return rc, buf.getvalue(), time.perf_counter() - t0


def cli_phase(ts: np.ndarray, vals: np.ndarray) -> dict:
    """The storage tools on the card: ``import`` of the corpus' first
    CLI_SERIES series as text lines, ``query`` of CLI_QUERY (max: exact on
    every plan), whose lines must equal a daemon's ``/q?ascii`` over the
    same WAL byte for byte, then ``scan --import`` back, whose lines must
    be the imported ones (values as the float32 the store keeps)."""
    out: dict = {"series": CLI_SERIES}
    start, end = BASE, BASE + SPAN - 1
    with tempfile.TemporaryDirectory() as d:
        wal = os.path.join(d, "wal")
        path = os.path.join(d, "corpus.txt")
        want = []
        with open(path, "w") as f:
            for s in range(CLI_SERIES):
                tags = series_tags(s)
                for t, v in zip(ts[s].tolist(), vals[s].tolist()):
                    f.write(f"bench.metric {t} {v!r} host={tags['host']} "
                            f"dc={tags['dc']}\n")
                    want.append(f"bench.metric {t} "
                                f"{float(np.float32(v))!r} "
                                f"dc={tags['dc']} host={tags['host']}")
        rc, said, out["import_s"] = run_cli("import", "--wal", wal, path)
        if rc or f"{len(want)} points" not in said:
            fail(f"tsdb import: exit {rc}: {said[-300:]!r}")
        rc, lines, out["query_s"] = run_cli(
            "query", "--wal", wal, str(start), str(end), "max",
            "downsample", "3600", "max", "bench.metric", "host=*")
        if rc or not lines:
            fail(f"tsdb query: exit {rc}, {len(lines)} bytes")
        tsdb = open_daemon_tsdb(wal)
        daemon = Daemon(tsdb)
        try:
            status, body = http_get(daemon.port, "/q?" + urllib.parse
                                    .urlencode({"start": start, "end": end,
                                                "m": CLI_QUERY,
                                                "ascii": ""}))
        finally:
            daemon.stop()
        if status != 200 or body.decode() != lines:
            fail(f"tsdb query's lines differ from the daemon's /q?ascii "
                 f"(HTTP {status})")
        rc, dumped, out["scan_s"] = run_cli(
            "scan", "--wal", wal, "--import", str(start), str(end),
            "bench.metric")
        if rc or sorted(dumped.splitlines()) != sorted(want):
            fail(f"tsdb scan --import: exit {rc}, not the imported lines")
    out.update({"lines": len(want), "query": CLI_QUERY,
                "query_lines": lines.count("\n"), "ascii_equal": True,
                "scan_lines": len(want), "roundtrip_equal": True})
    log(f"cli: {out}")
    return out


def compare_reference(daemon: "Daemon", tsdb: TSDB, start: int,
                      end: int, union: list) -> dict:
    """The ten resident queries (each once: its stage built) and the
    un-downsampled ``union`` queries on this daemon, each against the
    one-shard daemon's answer; launches counted per path."""
    dw, ex = tsdb.devwindow, daemon.server.executor
    out: dict = {"resident": {}, "union": {}, "launches": {}}
    ref = reference()
    zero_launches()
    for expr in QUERIES + PCT_QUERIES:
        run, got = http_resident(daemon.port, dw, ex, expr, start, end)
        want = ref["resident"][expr]
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
        want = ref["union"][expr]
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


def sketch_answers(port: int, start: int, end: int,
                   tap: "KernelTap | None" = None) -> dict:
    """Each sketch route's body and wall ms; with ``tap``, the route's
    name labels the kernel calls it makes."""
    out = {}
    for name, target in sketch_targets(start, end):
        if tap is not None:
            tap.label = (target.split("?")[0] + " "
                         + name.replace("distinct ", ""))
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


# ---------------------------------------------------------------------------
# Rollup phase (5e)
# ---------------------------------------------------------------------------

# The rollup phase folds the first ROLLUP_SERIES series of the corpus:
# on the H100 machine the host fold of the whole corpus took 95.6 s and
# the device fold of 2,500 series 28.3 s, so the whole corpus' host and
# device folds would take ~210 s, past the ~120 s the phase may spend
# folding in a smoke that already runs ~860 s of its 1200.
ROLLUP_SERIES = 2_500
ROLLUP_QUERIES = {"sum:1h-avg:bench.metric": "1h",
                  "sum:1h-avg:bench.metric{dc=*}": "1h",
                  "max:1d-max:bench.metric{host=h00001}": "1d",
                  "dev:1h-avg:bench.metric": "1h",
                  "p95:1h-avg:bench.metric{dc=*}": "1h",
                  "sum:1d-count:bench.metric": "1d"}
ROLLUP_DECLINES = {"sum:rate:1h-avg:bench.metric": "rate",
                   "sum:1h-p95:bench.metric": "dsagg-p95"}
ROLLUP_FOLD_WHERE = ("rollup_fold.cu", "opentsdb_tpu/rollup/summary.py:553")


# Earlier times of the kernels this tree redesigned: (name, stage) ->
# the PR that measured them and its numbers (PERF.md, H100 80GB HBM3 at
# 700 W). Not this run's: they go on a labelled stderr line of their own
# ("earlier"), beside this run's times at the same stages, and never into
# the kernels line.
EARLIER_MS = {
    ("rollup_fold", "one (series, day) of the corpus, res 3600"): {
        "pr": 17, "ms": 0.039983998984098434, "ms_cold": 0.014448000118136406,
        "ms_device": 0.0040352001786232},
    ("rollup_fold", "a week at a 1 s scrape, res 3600"): {
        "pr": 17, "ms": 0.05371199920773506, "ms_cold": 0.07329599931836128,
        "ms_device": 0.03420799970626831},
    ("holt_winters", "{host=*} 1h, season 24"): {
        "pr": 18, "ms": 0.11185599863529205, "ms_cold": 0.09011200070381165,
        "ms_device": 0.05545439720153809},
    ("holt_winters", "{dc=*} 5m, season 288"): {
        "pr": 18, "ms": 0.5465919971466064, "ms_cold": 0.5783680081367493,
        "ms_device": 0.4914576053619385},
    ("ewma_scan", "{host=*} 1h"): {
        "pr": 18, "ms": 0.031072000041604042,
        "ms_cold": 0.022127999924123287, "ms_device": 0.012777599692344665},
    ("ewma_scan", "{dc=*} 5m"): {
        "pr": 18, "ms": 0.1390719935297966, "ms_cold": 0.13473600149154663,
        "ms_device": 0.12465759515762329},
    ("hybrid_moment_combine", "week group, finish (2 x 2 x 256)"): {
        "pr": 24, "ms": 0.044096000492572784,
        "ms_cold": 0.022991999983787537, "ms_device": 0.004656000062823296},
    ("hybrid_moment_combine", "week group, a row's emit (1 x 2 x 256)"): {
        "pr": 24, "ms": 0.04681600071489811, "ms_cold": 0.053999999538064,
        "ms_device": 0.003364799916744232},
    ("hybrid_moment_combine",
     "week group, finish of the gathered rows (2 x 1 x 256)"): {
        "pr": 24, "ms": 0.05551999993622303,
        "ms_cold": 0.041120000183582306,
        "ms_device": 0.0034015998244285583},
}
ROLLUP_GROUP_STAGE = ("the tier's group: 2,500 series x one day, res 3600 "
                      "and 86400")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two tensors bit for bit (floats compared as integers)."""
    a, b = a.cpu(), b.cpu()
    if a.is_floating_point():
        a = a.view(torch.int64 if a.element_size() == 8 else torch.int32)
        b = b.view(torch.int64 if b.element_size() == 8 else torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def fold_case(stage: str, ts: np.ndarray, vals: np.ndarray, res: int,
              flush: torch.Tensor) -> dict:
    """The window-fold kernel on one series' sorted columns (its
    one-series entry ``window_fold``): held against its plain version on
    the card bit for bit (the plain version follows the kernel's order of
    addition) and against the host fold ``window_summaries`` (the sum
    within rtol 1e-12), then timed three ways beside the plain version
    and a three-call scatter composite (index_add_, amin, amax: not the
    same function, it has no brackets). The fold-count child counts its
    kernels a call (``start_fold_count``)."""
    dev = torch.device(DEVICE)
    origin = int(ts[0]) - int(ts[0]) % res
    W = (int(ts[-1]) - origin) // res + 1
    rel = torch.from_numpy((ts - origin).astype(np.int32)).to(dev)
    v = torch.from_numpy(np.asarray(vals, np.float64)).to(dev)
    offs = torch.tensor([0, len(ts)], dtype=torch.int64, device=dev)
    got = [x.cpu() for x in rollup_fold.window_fold(rel, v, num_windows=W,
                                                    res=res)]
    again = [x.cpu() for x in rollup_fold.window_fold(
        rel, v, num_windows=W, res=res)]
    plain = [x.cpu() for x in rollup_fold.window_fold_plain(
        rel, v, num_windows=W, res=res)]
    if not all(same_bits(a, b) for a, b in zip(got, again)):
        fail(f"rollup_fold [{stage}]: two calls differ")
    for i, name in enumerate(("count", "sum", "min", "max", "first", "last",
                              "t_first", "t_last")):
        if not same_bits(got[i], plain[i]):
            fail(f"rollup_fold [{stage}]: {name} differs from the plain "
                 f"version")
    wb, rec = rsummary.window_summaries(ts, vals, res)
    idx = (wb - origin) // res
    err = float(np.abs(got[1].numpy()[idx] - rec["sum"]).max())
    if not (np.array_equal(np.flatnonzero(got[0].numpy()), idx)
            and np.array_equal(got[2].numpy()[idx], rec["min"])
            and np.array_equal(got[5].numpy()[idx], rec["last"])
            and np.allclose(got[1].numpy()[idx], rec["sum"], rtol=1e-12,
                            atol=0)):
        fail(f"rollup_fold [{stage}]: records differ from the host fold")
    # The tier's one-series entry (window_fold behind the uploads and one
    # download).
    dwb, drec = rsummary.window_summaries_device(ts, vals, res,
                                                 device=DEVICE)
    if not (np.array_equal(dwb, wb) and all(
            np.array_equal(drec[f], rec[f]) for f in (
                "count", "min", "max", "first", "last", "first_dt",
                "last_dt"))
            and np.allclose(drec["sum"], rec["sum"], rtol=1e-12, atol=0)):
        fail(f"rollup_fold [{stage}]: window_summaries_device's records "
             f"differ from the host fold")
    w_ = torch.clamp(torch.div(rel.long(), res, rounding_mode="floor"),
                     0, W - 1)

    def scatter():
        s = torch.zeros(W, dtype=torch.float64, device=dev)
        s.index_add_(0, w_, v)
        mn = torch.full((W,), float("inf"), dtype=torch.float64,
                        device=dev).scatter_reduce_(0, w_, v, "amin")
        mx = torch.full((W,), float("-inf"), dtype=torch.float64,
                        device=dev).scatter_reduce_(0, w_, v, "amax")
        return s, mn, mx

    nbytes = 12 * len(ts) + 16 + 52 * W
    bms, by = bound_ms(nbytes, 0)
    res_ = {"name": "rollup_fold", "stage": stage, "points": len(ts),
            "series": 1, "windows": W, "res": res, "max_abs_err": err,
            "bound_ms": bms, "bound_by": by, "bytes": nbytes}
    time_case(res_, lambda: rollup_fold._fold_launch(rel, v, offs, (res,),
                                                     (W,)),
              lambda: rollup_fold._fold_plain(rel, v, offs, (res,), (W,)),
              None, flush)
    res_["library"] = NO_LIBRARY
    res_["scatter_composite_ms"] = median_ms(scatter)
    return res_


def group_fold_case(stage: str, ts: np.ndarray, vals: np.ndarray,
                    bounds: np.ndarray, res: tuple, flush) -> dict:
    """The window-fold kernel at the tier's group shape (every series of
    one coarse day at every resolution: one launch): bit for bit against
    its plain version on the card, every series' records against the host
    fold (the sum within rtol 1e-12) and, through the tier's entry
    ``group_summaries_device``, byte for byte against the same entry on
    the CPU; timed three ways beside the plain version; then the entry's
    host-inclusive time a group (uploads, launch, one read-back, the
    records) beside one pass of the one-series entry over the group's
    series and resolutions (the launches the tier made before) and of the
    host fold."""
    dev = torch.device(DEVICE)
    S = len(bounds) - 1
    W = tuple(DAY // r for r in res)
    rel = torch.from_numpy((ts - BASE).astype(np.int32)).to(dev)
    v = torch.from_numpy(np.asarray(vals, np.float64)).to(dev)
    offs = torch.from_numpy(bounds).to(dev)
    got = rollup_fold.window_fold_batch(rel, v, offs, res=res,
                                        num_windows=W)
    again = rollup_fold.window_fold_batch(rel, v, offs, res=res,
                                          num_windows=W)
    plain = rollup_fold.window_fold_batch_plain(rel, v, offs, res=res,
                                                num_windows=W)
    if not all(same_bits(a, b) for a, b in zip(got, again)):
        fail(f"rollup_fold [{stage}]: two calls differ")
    if not all(same_bits(a, b) for a, b in zip(got, plain)):
        fail(f"rollup_fold [{stage}]: differs from the plain version")
    out = rsummary.group_summaries_device(ts, vals, bounds, BASE, DAY, res,
                                          device=DEVICE)
    cpu = rsummary.group_summaries_device(ts, vals, bounds, BASE, DAY, res,
                                          device="cpu")
    err = 0.0
    for (wb, rec, st), (cwb, crec, cst), r in zip(out, cpu, res):
        if not (np.array_equal(wb, cwb) and np.array_equal(st, cst)
                and rec.tobytes() == crec.tobytes()):
            fail(f"rollup_fold [{stage}]: group_summaries_device differs "
                 f"from its CPU run")
        for j in range(S):
            a, b = bounds[j], bounds[j + 1]
            hwb, hrec = rsummary.window_summaries(ts[a:b], vals[a:b], r)
            got_rec = rec[st[j]:st[j + 1]]
            if not (np.array_equal(wb[st[j]:st[j + 1]], hwb) and all(
                    np.array_equal(got_rec[f], hrec[f]) for f in (
                        "count", "min", "max", "first", "last",
                        "first_dt", "last_dt"))
                    and np.allclose(got_rec["sum"], hrec["sum"],
                                    rtol=1e-12, atol=0)):
                fail(f"rollup_fold [{stage}]: series {j} at {r} differs "
                     f"from the host fold")
            if len(hrec):
                err = max(err, float(np.abs(got_rec["sum"]
                                            - hrec["sum"]).max()))
    N = rollup_fold.grid_slots(S, W)[-1]
    nbytes = 12 * len(ts) + 8 * (S + 1) + 52 * N
    bms, by = bound_ms(nbytes, 0)
    res_ = {"name": "rollup_fold", "stage": stage, "points": len(ts),
            "series": S, "windows": list(W), "res": list(res), "slots": N,
            "max_abs_err": err, "bound_ms": bms, "bound_by": by,
            "bytes": nbytes}
    time_case(res_, lambda: rollup_fold._fold_launch(rel, v, offs, res, W),
              lambda: rollup_fold._fold_plain(rel, v, offs, res, W), None,
              flush)
    res_["library"] = NO_LIBRARY
    res_["entry_ms"] = median_ms(lambda: rsummary.group_summaries_device(
        ts, vals, bounds, BASE, DAY, res, device=DEVICE), 5)
    t0 = time.perf_counter()
    for j in range(S):
        for r in res:
            rsummary.window_summaries_device(ts[bounds[j]:bounds[j + 1]],
                                             vals[bounds[j]:bounds[j + 1]],
                                             r, device=DEVICE)
    t1 = time.perf_counter()
    for j in range(S):
        for r in res:
            rsummary.window_summaries(ts[bounds[j]:bounds[j + 1]],
                                      vals[bounds[j]:bounds[j + 1]], r)
    t2 = time.perf_counter()
    res_["one_series_entry_ms"] = (t1 - t0) * 1e3
    res_["one_series_calls"] = S * len(res)
    res_["host_fold_ms"] = (t2 - t1) * 1e3
    log(f"rollup_fold group entry: {res_['entry_ms']:.2f} ms a group "
        f"against {res_['one_series_entry_ms']:.1f} ms through "
        f"{S * len(res):,} one-series calls and {res_['host_fold_ms']:.1f} "
        f"ms of host fold")
    return res_


def corpus_day_group(ts: np.ndarray, vals: np.ndarray, S: int) -> tuple:
    """(ts, vals, bounds) of the first day of the corpus' first S series,
    concatenated: the tier's group (one coarse day of the metric)."""
    cols = [(ts[s][ts[s] < BASE + DAY].astype(np.int64),
             vals[s][ts[s] < BASE + DAY].astype(np.float64))
            for s in range(S)]
    bounds = np.concatenate(([0], np.cumsum([len(t) for t, _ in cols])))
    return (np.concatenate([t for t, _ in cols]),
            np.concatenate([v for _, v in cols]), bounds.astype(np.int64))


def rollup_fold_cases() -> tuple:
    """The fold kernel at three shapes: the tier's group (the first day
    of the rollup phase's 2,500 series at 1 h and 1 d: one launch a
    group, the device-folded checkpoint's call), one (series, day) of the
    corpus (~143 points, 24 windows, res 3600: the call a (series,
    resolution) that the tier made before the group fold) and a week of
    one series at a 1 s scrape (604,800 points, 168 windows); and the
    cases of the child that counts their kernels
    (``start_fold_count``)."""
    ts, vals = corpus()
    group = corpus_day_group(ts, vals, ROLLUP_SERIES)
    del ts, vals
    small = (group[0][:group[2][1]], group[1][:group[2][1]])
    rng = np.random.default_rng(53)
    week = (BASE + np.arange(SPAN, dtype=np.int64),
            1000.0 + np.cumsum(rng.normal(0, 0.1, SPAN)))
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=DEVICE)
    out = [group_fold_case(ROLLUP_GROUP_STAGE, *group, (3600, DAY), flush),
           fold_case("one (series, day) of the corpus, res 3600",
                     *small, 3600, flush),
           fold_case("a week at a 1 s scrape, res 3600", *week, 3600,
                     flush)]
    del flush
    one = lambda t, v: (t, v, np.array([0, len(t)], np.int64))  # noqa
    return out, [([group], (3600, DAY), DAY, 3),
                 ([one(*small)], (3600,), DAY, 20),
                 ([one(*week)], (3600,), SPAN, 5)]


# Calls of group_summaries_device (the tier's checkpoint fold: one call a
# (metric, coarse window) group) under torch.profiler, in a fresh
# process: per case of the .npz in argv[1], one JSON line with the fold
# kernels the card ran, the calls made, the wrapper's own launch count
# over them and every other device event but copies; then the same calls
# timed without the profiler, and through the host fold window_summaries
# (us a call). The profiler's CUPTI trace has lost kernel records on a
# loaded card (99 of 100 fold kernels once in this child beside the path
# phase, 90 of 100 once in the smoke's own process, while the wrapper
# counted 100 launches and the records were right): a profile whose fold
# records fall short of the wrapper's launches, with no other device
# event, is taken again, up to PROFILES times, and each shortfall is
# reported ("records_lost"). Any other outcome is final, and
# join_fold_count holds it to one fold kernel a call.
FOLD_COUNT = """
import json, sys, time
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from opentsdb_tpu_torch.ops import rollup_fold
from opentsdb_tpu_torch.rollup import summary
PROFILES = 5


def fold(calls, origin, span, res):
    for ts, v, b in calls:
        summary.group_summaries_device(ts, v, b, origin, span, res,
                                       device="cuda")


def profiled(calls, origin, span, res):
    before = rollup_fold.window_fold.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fold(calls, origin, span, res)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    n = sum(k for name, k in names.items() if "window_fold" in name)
    other = {name: k for name, k in names.items()
             if "window_fold" not in name and "memcpy" not in name.lower()}
    return n, other, rollup_fold.window_fold.launches - before, wall


data = np.load(sys.argv[1])
for c in range(int(data["cases"])):
    calls = [(data[f"ts{c}_{i}"], data[f"v{c}_{i}"], data[f"b{c}_{i}"])
             for i in range(int(data[f"n{c}"]))] * int(data[f"repeat{c}"])
    res = tuple(int(r) for r in data[f"res{c}"])
    origin, span = int(data[f"origin{c}"]), int(data[f"span{c}"])
    fold(calls[:1], origin, span, res)
    torch.cuda.synchronize()
    lost = []
    for taken in range(1, PROFILES + 1):
        n, other, launched, wall = profiled(calls, origin, span, res)
        if n >= launched or other or launched != len(calls):
            break
        lost.append(launched - n)
    t0 = time.perf_counter()
    fold(calls, origin, span, res)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for ts, v, b in calls:
        for j in range(len(b) - 1):
            for r in res:
                summary.window_summaries(ts[b[j]:b[j + 1]],
                                         v[b[j]:b[j + 1]], r)
    t2 = time.perf_counter()
    print(json.dumps({
        "calls": len(calls), "series_per_call": len(calls[0][2]) - 1,
        "resolutions": list(res), "fold_kernels": n,
        "wrapper_launches": launched,
        "kernels_per_call": n / len(calls),
        "other_device_events": other,
        "profiles": taken, "records_lost": lost,
        "profiled_host_ms_per_call": wall / len(calls),
        "device_us_per_call": (t1 - t0) * 1e6 / len(calls),
        "host_fold_us_per_call": (t2 - t1) * 1e6 / len(calls)}))
"""


def start_count(script: str, arrays: dict) -> tuple:
    """``script`` in a child process over ``arrays`` (saved as an .npz,
    its argv[1]): started here, joined by ``join_count``. The kernel
    counts run beside the path phase (in the smoke's own process the
    profiler once recorded 90 fold kernels for 100 calls)."""
    root = os.path.dirname(os.path.abspath(__file__))
    d = tempfile.mkdtemp()
    path = os.path.join(d, "calls.npz")
    np.savez(path, **arrays)
    proc = subprocess.Popen([sys.executable, "-c", script, path],
                            cwd=root, env=dict(os.environ, PYTHONPATH=root),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, d, int(arrays["cases"])


def join_count(job: tuple, what: str) -> list:
    """The JSON line of each case from a ``start_count`` child."""
    proc, d, n = job
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if proc.returncode != 0:
        fail(f"the {what} kernel count failed: {stderr[-2000:]}")
    counts = [json.loads(ln) for ln in stdout.splitlines()
              if ln.startswith("{")]
    if len(counts) != n:
        fail(f"the {what} kernel count printed {stdout[-2000:]}")
    return counts


def start_fold_count(cases: list) -> tuple:
    """Each case, (groups [(ts, vals, bounds)], res, span, repeat),
    through group_summaries_device (origin BASE) ``repeat`` times over
    under torch.profiler in a child process."""
    arrays = {"cases": len(cases)}
    for c, (calls, res, span, repeat) in enumerate(cases):
        arrays.update({f"n{c}": len(calls), f"res{c}": np.asarray(res),
                       f"origin{c}": BASE, f"span{c}": span,
                       f"repeat{c}": repeat})
        for i, (ts, v, b) in enumerate(calls):
            arrays[f"ts{c}_{i}"] = ts
            arrays[f"v{c}_{i}"] = v
            arrays[f"b{c}_{i}"] = b
    return start_count(FOLD_COUNT, arrays)


def join_fold_count(job: tuple, records: list) -> None:
    """The fold-count child's counts onto the fold records: exactly one
    fold kernel a call, as many wrapper launches as calls and no other
    device event but copies, or the run fails. The first case is the
    tier's own call (the group of the first day of the rollup phase's
    series at both resolutions), reported with the rollup phase's device
    fold."""
    counts = join_count(job, "fold")
    for c in counts:
        if c["fold_kernels"] != c["calls"] or c["other_device_events"] \
                or c["wrapper_launches"] != c["calls"]:
            fail(f"group_summaries_device: not one fold kernel a call, "
                 f"or other device work: {c}")
    for r, c in zip(records, counts):
        r["kernels_per_call"] = c["kernels_per_call"]
        r["profiled"] = c
    records[0]["profiled_tier_calls"] = counts[0]


# ---------------------------------------------------------------------------
# Smoothing kernels and /forecast (models/)
# ---------------------------------------------------------------------------

# /forecast at full width on the path phase's daemon: (stage, m, params).
# The range is [BASE, BASE + SPAN]: 169 hourly and 2,017 five-minute
# buckets.
FORECASTS = [
    ("hw {host=*} 1h, season 24", "sum:1h-avg:bench.metric{host=*}",
     {"season": 24, "horizon": 24}),
    ("ewma {host=*} 1h", "sum:1h-avg:bench.metric{host=*}",
     {"horizon": 24, "model": "ewma"}),
    ("hw {dc=*} 5m, season 288", "sum:5m-avg:bench.metric{dc=*}",
     {"season": 288, "horizon": 24}),
]
SMOOTHING_WHERE = {
    "ewma_scan": ("smoothing.cu", "opentsdb_tpu/models/smoothing.py:25"),
    "holt_winters": ("smoothing.cu", "opentsdb_tpu/models/smoothing.py:50"),
}
# The chain's floor: the longest path of dependent operations a series,
# at Hopper's ~4-cycle dependent-issue latency, at the card's maximum SM
# clock. Holt-Winters: each of T steps waits on the previous one, 9
# operations on the level/trend path (add, mul, add, select, sub, mul,
# add, select, select). The EWMA's segmented scan: a segment's summaries,
# L steps of 3 (B: mul, add, select), the carries, ceil(T / L) steps of 4
# (mul, add, select, select), and the outputs from the carry, L steps of 4
# (mul, add, select, select): 3L + 4 ceil(T / L) + 4L operations.
DEP_LATENCY_CYCLES = 4


def chain_ops(name: str, T: int) -> int:
    if name == "ewma_scan":
        L = smoothing.EWMA_SEGMENT
        return 3 * L + 4 * -(-T // L) + 4 * L
    return 9 * T


# float32 operations a cell: the Holt-Winters fit (14) and bands (15);
# the EWMA (3).
CELL_OPS = {"holt_winters": 29, "ewma_scan": 3}


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()
    return float(out[0]) * 1e6


def corpus_grids(ts: np.ndarray, vals: np.ndarray) -> dict:
    """The model grids /forecast builds from the corpus, time-major:
    each series' hourly mean ([169, 10,000]) and each dc's five-minute
    sum of its hosts' means ([2,017, 10])."""
    out = {}
    for stage, step, by_dc in (("1h", 3600, False), ("5m", 300, True)):
        T = SPAN // step + 1
        b = (ts - BASE) // step
        rows = (np.arange(SERIES) % 10 if by_dc
                else np.arange(SERIES))[:, None].repeat(POINTS, 1)
        S = 10 if by_dc else SERIES
        cell = (b * S + rows).ravel()
        sums = np.bincount(cell, vals.ravel().astype(np.float64),
                           minlength=T * S)
        cnt = np.bincount(cell, minlength=T * S)
        mean = np.where(cnt > 0, sums / np.maximum(cnt, 1), 0.0)
        out[stage] = (mean.reshape(T, S).astype(np.float32),
                      (cnt > 0).reshape(T, S))
    return out


def smoothing_case(name: str, stage: str, grid: tuple, season: int,
                   horizon: int, clock_hz: float, flush,
                   launch_floor_ms: float) -> dict:
    """One smoothing kernel at /forecast's shape: bit for bit against its
    plain version on the card, timed three ways beside the plain version
    (3 runs: Python loops over T, or over the EWMA's segments), the byte /
    operation bound, the chain's floor and the launch floor (the empty
    kernel's ``ms_device``); ``share`` is the largest of the three over
    ``ms_device``."""
    dev = torch.device(DEVICE)
    v = torch.from_numpy(grid[0]).to(dev)
    m = torch.from_numpy(grid[1]).to(dev)
    T, S = v.shape
    kw = dict(alpha=0.3, beta=0.1, gamma=0.1, season=season, nsigma=3.0,
              resid_alpha=0.05, warmup=10, horizon=horizon)
    if name == "ewma_scan":
        got = {"ewma": smoothing.ewma_scan(v, m, 0.3)}
        want = {"ewma": smoothing.ewma_scan_plain(v, m, 0.3)}
        fn = lambda: smoothing.ewma_scan(v, m, 0.3)  # noqa: E731
        plain = lambda: smoothing.ewma_scan_plain(v, m, 0.3)  # noqa: E731
        nbytes = 9 * S * T
    else:
        got = smoothing.holt_winters_bands(v, m, **kw)
        want = smoothing.holt_winters_bands_plain(v, m, **kw)
        fn = lambda: smoothing.holt_winters_bands(v, m, **kw)  # noqa: E731
        plain = lambda: smoothing.holt_winters_bands_plain(  # noqa: E731
            v, m, **kw)
        nbytes = (22 * S * T + 4 * S * (2 + max(season, 1) + horizon))
    torch.cuda.synchronize()
    for k in want:
        if not torch.equal(got[k], want[k]):
            fail(f"{name} [{stage}]: {k} differs from the plain version")
    err = max(float((got[k].float() - want[k].float()).abs().max())
              for k in want if want[k].numel())
    bms, by = bound_ms(nbytes, CELL_OPS[name] * S * T)
    chain = chain_ops(name, T) * DEP_LATENCY_CYCLES / clock_hz * 1e3
    floors = {by: bms, "chain": chain, "launch": launch_floor_ms}
    binds = max(floors, key=floors.get)
    res = {"name": name, "stage": stage, "series": S, "steps": T,
           "season": season, "horizon": horizon, "max_abs_err": err,
           "bytes": nbytes, "bound_ms": bms, "bound_by": by,
           "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "chain_floor_ms": chain, "launch_floor_ms": launch_floor_ms,
           "binds": binds,
           "ms": median_ms(fn), "ms_cold": median_ms(fn, flush=flush),
           "ms_device": device_ms(fn), "plain_ms": median_ms(plain, 3),
           "library_ms": None, "library": NO_LIBRARY}
    if name == "ewma_scan":
        res["segment"] = smoothing.EWMA_SEGMENT
    res["share"] = floors[binds] / res["ms_device"]
    log(f"kernel {name} [{stage}]: {res['ms']:.4f} ms, cold "
        f"{res['ms_cold']:.4f}, device {res['ms_device']:.4f} (plain "
        f"{res['plain_ms']:.1f}; bytes {res['bytes_bound_ms']:.5f}, chain "
        f"floor {chain:.5f}, launch floor {launch_floor_ms:.5f}: {binds} "
        f"binds, share {res['share']:.3f})")
    return res


# run_model (one /forecast's model step) under torch.profiler, in a fresh
# process: per grid of the .npz in argv[1], one JSON line with the
# smoothing kernels the card ran for one call, the wrappers' own launch
# count and every other device event but copies. A profile that lost a
# kernel record (FOLD_COUNT) is taken again, up to PROFILES times.
FORECAST_COUNT = """
import json, sys
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from opentsdb_tpu_torch.models import forecast as mf
from opentsdb_tpu_torch.ops import smoothing
PROFILES = 5
MODEL = ("ewma_kernel", "ewma_cluster_kernel", "holt_winters_kernel")


def launches():
    return smoothing.ewma_scan.launches + smoothing.holt_winters_bands.launches


def profiled(grid, opts):
    before = launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mf.run_model(grid, opts, "cuda")
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    model = sum(n for k, n in names.items() if any(m in k for m in MODEL))
    other = {k: n for k, n in names.items()
             if not any(m in k for m in MODEL) and "memcpy" not in k.lower()}
    return model, other, launches() - before


data = np.load(sys.argv[1])
for c in range(int(data["cases"])):
    grid = mf.Grid(data[f"v{c}"], data[f"m{c}"], 0, 3600)
    opts = mf.ForecastOpts(str(data[f"model{c}"]), 24,
                           int(data[f"season{c}"]), 0.3, 0.1, 0.1, 3.0)
    mf.run_model(grid, opts, "cuda")
    torch.cuda.synchronize()
    lost = []
    for taken in range(1, PROFILES + 1):
        model, other, launched = profiled(grid, opts)
        if model >= launched or other or launched != 1:
            break
        lost.append(launched - model)
    print(json.dumps({"model_kernels": model, "wrapper_launches": launched,
                      "other_device_events": other, "profiles": taken,
                      "records_lost": lost}))
"""


def start_forecast_count(cases: list) -> tuple:
    """Each case, (grid, model, season), through ``run_model`` once under
    torch.profiler in a child process (``start_count``)."""
    arrays = {"cases": len(cases)}
    for c, (grid, model, season) in enumerate(cases):
        arrays.update({f"v{c}": grid[0], f"m{c}": grid[1],
                       f"model{c}": model, f"season{c}": season})
    return start_count(FORECAST_COUNT, arrays)


def join_forecast_count(job: tuple, records: list) -> None:
    """The child's counts onto the smoothing records (``kernels_per_call``):
    exactly one smoothing kernel and one wrapper launch a /forecast and
    no other device event but copies, or the run fails."""
    counts = join_count(job, "forecast")
    if any(c["model_kernels"] != 1 or c["other_device_events"]
           or c["wrapper_launches"] != 1 for c in counts):
        fail(f"run_model: not one smoothing kernel a /forecast, or other "
             f"device work: {counts}")
    # The cases' order: hw 1h, ewma 1h, hw 5m (ewma 5m: as ewma 1h).
    for r, c in zip(records, counts + counts[1:2]):
        r["kernels_per_call"] = c["model_kernels"]
        r["profiled"] = c


def smoothing_kernel_cases(ts: np.ndarray, vals: np.ndarray,
                           launch_floor_ms: float) -> tuple:
    """Both smoothing kernels at /forecast's two grids (see
    ``smoothing_case``), and the cases of the child that counts the
    kernels of one /forecast (``start_forecast_count``)."""
    grids = corpus_grids(ts, vals)
    clock = max_sm_clock_hz()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=DEVICE)
    out = [smoothing_case(name, stage, grids[g], season, 24, clock, flush,
                          launch_floor_ms)
           for name, stage, g, season in (
               ("holt_winters", "{host=*} 1h, season 24", "1h", 24),
               ("ewma_scan", "{host=*} 1h", "1h", 0),
               ("holt_winters", "{dc=*} 5m, season 288", "5m", 288),
               ("ewma_scan", "{dc=*} 5m", "5m", 0))]
    del flush
    for r in out:
        r["sm_clock_hz"] = clock
    return out, [(grids["1h"], "hw", 24), (grids["1h"], "ewma", 0),
                 (grids["5m"], "hw", 288)]


def forecast_phase(daemon: "Daemon") -> dict:
    """/forecast at full width (see FORECASTS): each answer's wall ms, its
    kernel launches (one of its model's kernel), the in-process split
    (``executor.run`` of its series, the model step, the JSON build) and
    checks: the in-process model outputs bit for bit against the plain
    versions on the card, and the HTTP answer against the in-process one
    (timestamps and keys equal, values within float32 tolerance: the
    resident sums' atomics add in a run-dependent order; anomaly flags
    equal but at cells within that tolerance of a band)."""
    start, end = BASE, BASE + SPAN
    ex = daemon.server.executor
    out = {"launches": {"ewma_scan": 0, "holt_winters": 0}, "runs": {}}
    for stage, expr, params in FORECASTS:
        target = "/forecast?" + urllib.parse.urlencode(
            {"start": start, "end": end, "m": expr, **params})
        before = (smoothing.ewma_scan.launches,
                  smoothing.holt_winters_bands.launches)
        q0 = time.perf_counter()
        status, body = http_get(daemon.port, target)
        wall = (time.perf_counter() - q0) * 1e3
        n = (smoothing.ewma_scan.launches - before[0],
             smoothing.holt_winters_bands.launches - before[1])
        if status != 200:
            fail(f"{target}: HTTP {status}: {body[:300]!r}")
        model = params.get("model", "hw")
        if n != ((1, 0) if model == "ewma" else (0, 1)):
            fail(f"{stage}: launches (ewma, hw) {n}, not one of its model")
        out["launches"]["ewma_scan"] += n[0]
        out["launches"]["holt_winters"] += n[1]
        answer = json.loads(body)
        # In process, the same steps, each timed.
        spec = spec_of(expr)
        opts = mforecast.ForecastOpts(model, params["horizon"],
                                      params.get("season", 0), 0.3, 0.1,
                                      0.1, 3.0)
        t0 = time.perf_counter()
        results = ex.run(spec, start, end)
        t1 = time.perf_counter()
        grid = mforecast.model_grid(results, start, end, spec.downsample[0])
        t2 = time.perf_counter()
        got = mforecast.run_model(grid, opts, DEVICE)
        t3 = time.perf_counter()
        mine = mforecast.body(results, grid, got, opts)
        t4 = time.perf_counter()
        T, S = grid.values.shape
        v = torch.from_numpy(grid.values).to(DEVICE).t()
        m = torch.from_numpy(grid.mask).to(DEVICE).t()
        if model == "ewma":
            want = {"fitted": msmooth.ewma_plain(v, m, 0.3)}
        else:
            want = msmooth.anomaly_bands_plain(
                v, m, 0.3, 0.1, 0.1, opts.season, 3.0,
                horizon=opts.horizon)
        for k in want:
            if k in got and not np.array_equal(got[k],
                                               want[k].cpu().numpy()):
                fail(f"{stage}: {k} differs from the plain version")
        if len(answer) != S:
            fail(f"{stage}: {len(answer)} series answered, {S} expected")
        flips = 0
        scale = float(np.abs(grid.values).max()) or 1.0
        grid_ts = grid.grid0 + np.arange(T) * grid.interval
        fkeys = [str(grid.grid0 + (T + j) * grid.interval)
                 for j in range(opts.horizon)]
        for i, (a, r) in enumerate(zip(answer, results)):
            real = np.flatnonzero(grid.mask[:, i])
            keys = [str(t) for t in grid_ts[real].tolist()]
            if a["tags"] != r.tags or list(a["forecast"]) != fkeys or any(
                    list(a[k]) != keys for k in ("fitted", "upper", "lower")
                    if k in a):
                fail(f"{stage}: series {i}: tags or timestamps differ")
            for k in ("fitted", "forecast", "upper", "lower"):
                if k in a and not np.allclose(
                        np.fromiter(a[k].values(), float),
                        got[k][i] if k == "forecast" else got[k][i, real],
                        rtol=1e-4, atol=1e-5 * scale):
                    fail(f"{stage}: series {i}: {k} beyond tolerance")
            mine_an = (grid_ts[got["anomaly"][i]].tolist()
                       if "anomaly" in got else None)
            if a.get("anomalies") != mine_an:
                for t_ in set(a["anomalies"]) ^ set(mine_an):
                    j = (t_ - grid.grid0) // grid.interval
                    x = float(grid.values[j, i])
                    near = min(abs(x - got["upper"][i, j]),
                               abs(x - got["lower"][i, j]))
                    if near > 1e-4 * abs(x) + 1e-5 * scale:
                        fail(f"{stage}: series {i}: anomaly at {t_} "
                             f"differs {near} from any band")
                    flips += 1
        run = out["runs"][stage] = {
            "m": expr, "params": params, "series": S, "steps": T,
            "wall_ms": wall, "run_ms": (t1 - t0) * 1e3,
            "grid_ms": (t2 - t1) * 1e3, "model_ms": (t3 - t2) * 1e3,
            "json_ms": (t4 - t3) * 1e3, "body_bytes": len(body),
            "in_process_body_bytes": len(mine),
            "anomalies": sum(len(e.get("anomalies", ())) for e in answer),
            "anomaly_flips_near_band": flips}
        log(f"forecast {stage}: {run}")
    return out


# Approximate serving over the rollup daemon's tier (moment columns at 1h,
# t-digest at 1d): (m, extra /q params, the plan every group must carry).
# The exact answers (plan "raw") are the references of the approximate
# ones; max_error=1e-9 is a budget no sketch meets.
APPROX_QUERIES = [
    ("sum:1h-p95:bench.metric", {"approx": "1"}, "approx-1h"),
    ("sum:1h-p95:bench.metric", {"max_error": "0.000000001"}, "raw"),
    ("max:1d-p99:bench.metric{dc=*}", {"max_error": "10"}, "approx-1d"),
    ("max:1d-p99:bench.metric{dc=*}", {}, "raw"),
]
# The budgeted tier: its budget (bytes) and series.
APPROX_BUDGET, BUDGET_TIER_SERIES = 300_000, 200


def approx_phase(daemon: "Daemon", start: int, end: int) -> dict:
    """``/q`` with ``approx=1`` and ``max_error=`` over the tier (see
    APPROX_QUERIES): each approximate answer declares its kind and bound
    (per result and in ``X-Tsd-Approx``) and lies within that bound of
    the exact answer, bucket for bucket; an unmet budget answers exactly;
    ``/api/queries`` counts the approximate plans."""
    out: dict = {}
    plans0 = http_json(daemon.port, "/api/queries")["plans"]
    exact: dict = {}
    for expr, params, plan in APPROX_QUERIES:
        target = "/q?" + urllib.parse.urlencode(
            {"start": start, "end": end, "m": expr, "json": "", **params})
        conn = http.client.HTTPConnection("127.0.0.1", daemon.port,
                                          timeout=600)
        q0 = time.perf_counter()
        conn.request("GET", target)
        resp = conn.getresponse()
        body = resp.read()
        wall = (time.perf_counter() - q0) * 1e3
        hdr = resp.getheader("X-Tsd-Approx")
        conn.close()
        if resp.status != 200:
            fail(f"{target}: HTTP {resp.status}: {body[:300]!r}")
        answer = json.loads(body)
        if not answer or any(g["rollup"] != plan for g in answer):
            fail(f"{target}: not served {plan}")
        key = f"{expr} {urllib.parse.urlencode(params)}"
        run = out[key] = {"plan": plan, "ms": wall, "header": hdr,
                          "groups": len(answer)}
        if plan == "raw":
            if hdr or any("approx" in g for g in answer):
                fail(f"{target}: an exact answer declares approximation")
            exact[expr] = answer
            continue
        if not hdr or any("approx" not in g for g in answer):
            fail(f"{target}: no declared bound")
        run["approx"] = answer[0]["approx"]
        run["answer"] = answer
    for key, run in out.items():
        if run["plan"] == "raw":
            continue
        expr = key.split(" ")[0]
        worst = 0.0
        for a, e in zip(run.pop("answer"), exact[expr]):
            if a["tags"] != e["tags"] or list(a["dps"]) != list(e["dps"]):
                fail(f"{key}: buckets differ from the exact answer")
            diff = np.abs(np.array(list(a["dps"].values()))
                          - np.array(list(e["dps"].values())))
            if (diff > a["approx"]["error"] * (1 + 1e-9)).any():
                fail(f"{key}: beyond its reported bound "
                     f"{a['approx']['error']}: {diff.max()}")
            worst = max(worst, float(diff.max()))
        run["max_abs_diff_to_exact"] = worst
    api = http_json(daemon.port, "/api/queries")
    approx_n = sum(plan != "raw" for _, _, plan in APPROX_QUERIES)
    if api["plans"].get("approx", 0) - plans0.get("approx", 0) != approx_n:
        fail(f"/api/queries counts {api['plans']} approximate plans")
    out["api_queries_sketch"] = api["sketch"]
    log(f"approximate serving: {out}")
    return out


def budgeted_tier(ts: np.ndarray, vals: np.ndarray) -> dict:
    """A tier under ``sketch_byte_budget`` (the first BUDGET_TIER_SERIES
    series, one checkpoint), then ``tsdb sketch-plan
    --sketch-byte-budget`` on its store: the table, and the tier's
    allocation that of ``sketch/budget.allocate``."""
    with tempfile.TemporaryDirectory() as d:
        wal = os.path.join(d, "wal")
        btsdb = open_tsdb(Config(auto_create_metrics=True, device=DEVICE,
                                 device_window=False, enable_rollups=True,
                                 sketch_byte_budget=APPROX_BUDGET), wal)
        try:
            for s in range(BUDGET_TIER_SERIES):
                btsdb.add_batch("bench.metric", ts[s], vals[s],
                                series_tags(s))
            ck = timed_checkpoint(btsdb, "budgeted tier checkpoint")
            alloc = {str(r): list(a)
                     for r, a in btsdb.rollups.sketch_alloc.items()}
            sketch_bytes = dict(btsdb.rollups.sketch_bytes)
        finally:
            btsdb.shutdown()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = port_cli.main(["sketch-plan", "--wal", wal, "--device",
                                DEVICE, "--sketch-byte-budget",
                                str(APPROX_BUDGET)])
        plan_s = time.perf_counter() - t0
    text = buf.getvalue()
    if rc != 0 or not text.startswith(
            f"sketch byte budget: {APPROX_BUDGET:,} B") \
            or "planned total:" not in text:
        fail(f"sketch-plan: rc {rc}: {text!r}")
    return {"budget": APPROX_BUDGET, "series": BUDGET_TIER_SERIES,
            "alloc": alloc, "sketch_bytes": sketch_bytes,
            "checkpoint_s": ck["seconds"], "sketch_plan_s": plan_s,
            "sketch_plan": text.splitlines()}


def open_rollup_tsdb(wal: str, **over) -> TSDB:
    """The rollup daemon's TSDB, opened as ``tsdb tsd --rollups`` does:
    default Config but the tier on and the window off (it would answer
    first)."""
    cfg = Config(auto_create_metrics=True, port=0, bind="127.0.0.1",
                 device=DEVICE, device_window=False, enable_rollups=True,
                 **over)
    tsdb = open_tsdb(cfg, wal)
    tune_for_ingest()
    if tsdb.rollups is None or tsdb.devwindow is not None:
        fail("the rollup daemon came up without its tier or with the "
             "window")
    return tsdb


def tier_bytes(tsdb: TSDB) -> int:
    return sum(os.path.getsize(os.path.join(d, fn))
               for dirs in tsdb.rollups._dirs.values() for d in dirs
               for fn in os.listdir(d))


def tier_records(tsdb: TSDB) -> dict:
    """{(res, row key): (moment map entries, sketch map bytes)}."""
    tier, out = tsdb.rollups, {}
    for r, stores in tier.stores.items():
        for s in stores:
            for key, items in s.scan_raw(tier.table, b"", b"",
                                         family=b"r"):
                cells = dict(items)
                out[(r, bytes(key))] = (
                    rsummary.decode_moment_map(cells[b"\x00"]),
                    cells.get(b"\x01"))
    return out


def http_rollup(port: int, expr: str, start: int, end: int,
                plan: str) -> tuple[float, list]:
    """One /q whose every group must carry ``plan``: (wall ms, answer)."""
    target = "/q?" + urllib.parse.urlencode(
        {"start": start, "end": end, "m": expr, "json": ""})
    q0 = time.perf_counter()
    status, body = http_get(port, target)
    wall = (time.perf_counter() - q0) * 1e3
    if status != 200:
        fail(f"{expr}: HTTP {status}: {body[:300]!r}")
    answer = json.loads(body)
    if not answer or any(g["rollup"] != plan for g in answer):
        fail(f"{expr}: not served {plan}: "
             f"{sorted({g.get('rollup') for g in answer})}")
    return wall, answer


def rollup_answers(port: int, start: int, end: int) -> dict:
    return {expr: http_rollup(port, expr, start, end, plan)[1]
            for expr, plan in ROLLUP_QUERIES.items()}


def rollup_against_raw(tsdb: TSDB, answers: dict, start: int,
                       end: int) -> dict:
    """Each query of ``answers`` on the float64 oracle backend, from the
    tier and from a raw scan (the tier set aside): bit-equal, since every
    bucket is one window; and the daemon's card answer against that
    oracle answer."""
    ex = QueryExecutor(tsdb, backend="cpu")
    out = {}
    for expr in answers:
        plan = ROLLUP_QUERIES[expr]
        spec = spec_of(expr)
        rolled, got_plan, _ = ex.run_with_plan(spec, start, end)
        saved, tsdb.rollups = tsdb.rollups, None
        try:
            raw, raw_plan, _ = ex.run_with_plan(spec, start, end)
        finally:
            tsdb.rollups = saved
        if (got_plan, raw_plan) != (plan, "raw"):
            fail(f"{expr}: plans {got_plan} / {raw_plan}")
        if len(rolled) != len(raw) or any(
                a.tags != b.tags
                or not np.array_equal(a.timestamps, b.timestamps)
                or not np.array_equal(a.values, b.values)
                for a, b in zip(rolled, raw)):
            fail(f"{expr}: the rollup answer is not the raw scan's")
        out[expr] = {"equal_to_raw": True, "oracle_rel_err": check_answer(
            expr, answers[expr], raw, 1e-4, "oracle")}
    return out


def rollup_phase(ts: np.ndarray, vals: np.ndarray) -> dict:
    """See 5e in the module docstring."""
    S = ROLLUP_SERIES
    start, end = BASE, BASE + SPAN - 1
    out: dict = {"series": S, "of_series": SERIES}
    log(f"rollup phase over the first {S:,} of {SERIES:,} series: the "
        f"whole corpus' host and device folds would take ~210 s")
    fold_timer = METRICS.timer("rollup.fold")
    steps = out["step_s"] = {}
    mark = [time.perf_counter()]

    def step(name: str) -> None:
        now = time.perf_counter()
        steps[name] = now - mark[0]
        mark[0] = now

    with tempfile.TemporaryDirectory() as d:
        wal = os.path.join(d, "wal")
        tsdb = open_rollup_tsdb(wal)
        daemon = Daemon(tsdb)
        try:
            t0 = time.perf_counter()
            for s in range(S):
                tsdb.add_batch("bench.metric", ts[s], vals[s],
                               series_tags(s))
            secs = time.perf_counter() - t0
            out["ingest"] = {"points": S * POINTS, "seconds": secs,
                             "points_per_s": S * POINTS / secs}
            f0 = fold_timer.total_ms
            ck = out["checkpoint_1"] = timed_checkpoint(
                tsdb, "rollup checkpoint 1")
            tier = tsdb.rollups
            ck["fold_s"] = (fold_timer.total_ms - f0) / 1e3
            ck["records"] = tier.records_written
            ck["tier_bytes"] = tier_bytes(tsdb)
            ck["fold_split"] = {"delta": tier.fold_delta,
                                "full": tier.fold_full}
            stats = stat_lines(daemon.port)
            ck["rollup.fold"] = stats.get("tsd.rollup.fold", {})
            if not tier.ready or "kind=host-f64" not in ck["rollup.fold"]:
                fail(f"rollup checkpoint 1: tier not ready or wrong kind "
                     f"{ck['rollup.fold']}")
            log(f"rollup checkpoint 1: fold {ck['fold_s']:.2f} s, "
                f"{ck['records']} records, {ck['tier_bytes']} tier bytes, "
                f"fold split {ck['fold_split']}")
            host_records = tier_records(tsdb)
            step("ingest + checkpoint 1")

            # The six queries: cold, then WARM_REPS warm, and each once
            # under the profiler (its card time).
            ex = daemon.server.executor
            zero_launches()
            runs, answers = {}, {}
            for expr, plan in ROLLUP_QUERIES.items():
                walls = []
                for _ in range(1 + WARM_REPS):
                    wall, answers[expr] = http_rollup(daemon.port, expr,
                                                      start, end, plan)
                    walls.append(wall)
                prof = profile_share(ex, spec_of(expr), start, end, plan)
                runs[expr] = {"plan": plan, "first_ms": walls[0],
                              "warm_ms": statistics.median(walls[1:]),
                              "warm_runs": walls[1:],
                              "card": {k: prof[k] for k in (
                                  "wall_ms", "device_busy_ms",
                                  "device_busy_share")}}
                log(f"rollup {expr}: {runs[expr]}")
            out["launches"] = path_launches("rollup path",
                                            ("segment_sum",
                                             "masked_select"))
            step("queries")
            checks = rollup_against_raw(tsdb, answers, start, end)
            step("raw and oracle checks")
            for expr in runs:
                runs[expr].update(checks[expr])
            out["queries"] = runs
            # Over one day: a decline is decided before the range is read.
            declines = {}
            for expr, reason in ROLLUP_DECLINES.items():
                n0 = tier.fallbacks.get(reason, 0)
                wall, _ = http_rollup(daemon.port, expr, start,
                                      start + DAY - 1, "raw")
                if tier.fallbacks.get(reason, 0) != n0 + 1:
                    fail(f"{expr}: no {reason} decline counted")
                declines[expr] = {"reason": reason, "ms": wall}
            out["declines"] = declines
            step("declines")

            # A backfill into a folded hour: that window is dirty and
            # stitched from raw, the answers still the raw scan's.
            said = telnet(daemon.port, [
                f"put bench.metric {BASE + 3600 + 17} 123.5 host=h00000 "
                f"dc=dc0"])
            if "put:" in said:
                fail(f"the backfill put answered {said!r}")
            if BASE + 3600 not in tier.dirty_hour_bases().tolist():
                fail("the backfilled hour is not dirty")
            expr = next(iter(ROLLUP_QUERIES))
            _, answer = http_rollup(daemon.port, expr, start, end,
                                    ROLLUP_QUERIES[expr])
            rollup_against_raw(tsdb, {expr: answer}, start, end)
            out["backfill"] = {"hour": BASE + 3600, "query": expr,
                               "stitched": True}
            out["checkpoint_2"] = timed_checkpoint(
                tsdb, "rollup checkpoint 2")
            step("backfill + checkpoint 2")

            # Ranged week /sketch and /distinct.
            ranged = {}
            for target, label, key in (
                    (f"/sketch?m=bench.metric&start={start}&end={end}",
                     "1d", "rollup"),
                    (f"/distinct?metric=bench.metric&tagk=host"
                     f"&start={start}&end={end}", "rollup", "source")):
                conn = http.client.HTTPConnection("127.0.0.1", daemon.port,
                                                  timeout=600)
                q0 = time.perf_counter()
                conn.request("GET", target)
                resp = conn.getresponse()
                body = json.loads(resp.read())
                wall = (time.perf_counter() - q0) * 1e3
                hdr = resp.getheader("X-Tsd-Approx")
                conn.close()
                if resp.status != 200 or body.get(key) != label:
                    fail(f"{target}: {resp.status} {body}")
                ranged[target.split("?")[0]] = {"ms": wall, "header": hdr,
                                                "answer": body}
            if not (ranged["/sketch"]["header"] or "").startswith(
                    "tdigest;rel_error=") \
                    or ranged["/distinct"]["answer"]["distinct"] != S:
                fail(f"ranged sketch routes: {ranged}")
            out["ranged"] = ranged
            log(f"rollup ranged routes: {ranged}")
            reference = rollup_answers(daemon.port, start, end)
            step("ranged routes")
            out["approx"] = approx_phase(daemon, start, end)
            step("approximate serving")

            # A restart adopts the tier: no rebuild, the same answers.
            daemon.stop()
            t0 = time.perf_counter()
            tsdb = open_rollup_tsdb(wal)
            out["boot_s"] = time.perf_counter() - t0
            daemon = Daemon(tsdb)
            if tsdb.rollups.rebuilds != 0 or not tsdb.rollups.ready:
                fail("the restart rebuilt the tier")
            after = rollup_answers(daemon.port, start, end)
            out["after_restart"] = {
                expr: same_answer(expr, after[expr], reference[expr],
                                  expr.startswith(("max", "p")))
                for expr in ROLLUP_QUERIES}
            step("restart")

            # A crash between the spill and the fold: the reopen catches
            # the in-flight windows up, the answers still the same.
            said = telnet(daemon.port, [
                f"put bench.metric {BASE + 5 * 3600 + 23} 77.25 "
                f"host=h00002 dc=dc2"])
            if "put:" in said:
                fail(f"the second backfill put answered {said!r}")
            before_crash = rollup_answers(daemon.port, start, end)
            faultpoints.arm("rollup.fold.start", "raise")
            try:
                tsdb.checkpoint()
                fail("the armed fold did not raise")
            except faultpoints.FaultInjected:
                pass
            finally:
                faultpoints.clear()
            tsdb.compactionq.shutdown()
            tsdb._shutdown_done = True      # the process dies: no shutdown
            daemon.stop()
            tsdb.rollups._simulate_crash()
            tsdb.store._simulate_crash()
            t0 = time.perf_counter()
            tsdb = open_rollup_tsdb(wal, rollup_catchup="sync")
            out["crash_reopen_s"] = time.perf_counter() - t0
            daemon = Daemon(tsdb)
            if tsdb.rollups.rebuilds != 1 or not tsdb.rollups.ready:
                fail(f"the crash reopen did not rebuild: "
                     f"{tsdb.rollups.rebuilds}")
            after = rollup_answers(daemon.port, start, end)
            out["after_crash"] = {
                expr: same_answer(expr, after[expr], before_crash[expr],
                                  expr.startswith(("max", "p")))
                for expr in ROLLUP_QUERIES}
            out["api_queries"] = http_json(daemon.port,
                                           "/api/queries")["rollup"]
            # A replica of the store serves the six shapes from the
            # writer's tier, the writer's bytes.
            out["replica"] = replica_check(
                daemon, wal, [(e, start, end) for e in ROLLUP_QUERIES],
                ROLLUP_QUERIES)
            log(f"rollup restart: boot {out['boot_s']:.2f} s; crash "
                f"reopen (catch-up) {out['crash_reopen_s']:.2f} s")
            # The store again as a --cluster writer, a replica and a
            # router process: the degraded step and failover, over the
            # week's first day (the writer's exact answer is a host scan
            # that shares the host with the path phase).
            daemon.stop()
            out["router"] = failover_leg(wal, start, start + DAY - 1)
        finally:
            daemon.stop()
    step("crash + reopen")
    out["approx"]["sketch_plan"] = budgeted_tier(ts, vals)
    step("budgeted tier + sketch-plan")

    # The same corpus folded on the card: the window-fold kernel.
    with tempfile.TemporaryDirectory() as d:
        dtsdb = open_tsdb(Config(auto_create_metrics=True, device=DEVICE,
                                 device_window=False, enable_rollups=True,
                                 rollup_device_fold=True),
                          os.path.join(d, "wal"))
        try:
            for s in range(S):
                dtsdb.add_batch("bench.metric", ts[s], vals[s],
                                series_tags(s))
            # Each group fold's inputs and records, kept (not copied: the
            # tier hands it fresh arrays) to be held against the plain
            # version on the host after the checkpoint.
            groups = []
            group_fold = dtsdb.rollups._group_fold

            def kept(ts_, vals_, bounds, origin, span, res):
                out_ = group_fold(ts_, vals_, bounds, origin, span, res)
                groups.append((ts_, vals_, bounds, origin, span, res, out_))
                return out_

            dtsdb.rollups._group_fold = kept
            rollup_fold.window_fold.launches = 0
            f0 = fold_timer.total_ms
            dck = timed_checkpoint(dtsdb, "device-folded checkpoint")
            dck["fold_s"] = (fold_timer.total_ms - f0) / 1e3
            launches = rollup_fold.window_fold.launches
            if launches == 0:
                fail("the device-folded checkpoint never launched "
                     "rollup_fold")
            if launches > len(groups):
                fail(f"the device-folded checkpoint launched rollup_fold "
                     f"{launches} times for {len(groups)} groups")
            dev_records = tier_records(dtsdb)
            kind = dtsdb.rollups.fold_kind
        finally:
            dtsdb.shutdown()
    t0 = time.perf_counter()
    for ts_, vals_, bounds, origin, span, res, out_ in groups:
        want = rsummary.group_summaries_device(ts_, vals_, bounds, origin,
                                               span, res, device="cpu")
        for (wb, rec, st), (pwb, prec, pst) in zip(out_, want):
            if not (np.array_equal(wb, pwb) and np.array_equal(st, pst)
                    and rec.tobytes() == prec.tobytes()):
                fail("device-folded tier: a group's records differ from "
                     "the plain version's on the host")
    plain_check_s = time.perf_counter() - t0
    if dev_records.keys() != host_records.keys() or kind != "device-f64":
        fail(f"device-folded tier: {kind}, rows differ from the host's")
    worst = 0.0
    for k, (m, sk) in host_records.items():
        dm, dsk = dev_records[k]
        if sk != dsk or not np.array_equal(m["idx"], dm["idx"]):
            fail(f"device-folded tier: {k} differs in its windows")
        for f in ("count", "min", "max", "first", "last", "first_dt",
                  "last_dt"):
            if not np.array_equal(m["rec"][f], dm["rec"][f]):
                fail(f"device-folded tier: {f} differs at {k}")
        a, b = m["rec"]["sum"], dm["rec"]["sum"]
        if not np.allclose(b, a, rtol=1e-12, atol=0):
            fail(f"device-folded tier: sum beyond rtol 1e-12 at {k}")
        worst = max(worst, float((np.abs(b - a) / np.maximum(
            np.abs(a), 1e-300)).max()))
    out["device_fold"] = {"checkpoint": dck, "fold_s": dck["fold_s"],
                          "host_fold_s": out["checkpoint_1"]["fold_s"],
                          "launches": launches, "groups": len(groups),
                          "series_per_group": [len(g[2]) - 1
                                               for g in groups],
                          "plain_check_s": plain_check_s, "kind": kind,
                          "records": sum(len(m) for m, _ in
                                         dev_records.values()),
                          "sum_max_rel_err": worst}
    step("device-folded tier")
    d = out["device_fold"]
    log(f"device-folded checkpoint: rollup_fold launched {launches} times "
        f"for {len(groups)} groups; fold_s {d['fold_s']:.2f} against the "
        f"host fold's {d['host_fold_s']:.2f}")
    log(f"device-folded tier: {out['device_fold']}; steps {steps}")
    return out


# ---------------------------------------------------------------------------
# Mesh phase: the serving mesh in one process (ROADMAP item 11a)
# ---------------------------------------------------------------------------

# D logical shards of one card: per-shard work and the combines, no
# interconnect.
MESH_D = 4
# The scan legs, each with its range from BASE: series-sharded (a group
# of >= D series), multigroup (groups split across the shards; {host=*}
# is the combine kernel's full width) and time-sharded (one series, >= 4
# buckets a shard).
MESH_SCAN = [("sum:1h-avg:bench.metric", DAY),
             ("p95:1h-avg:bench.metric", DAY),
             ("sum:1h-avg:bench.metric{dc=*}", DAY),
             ("p95:1h-avg:bench.metric{dc=*}", DAY),
             ("sum:1h-avg:bench.metric{host=*}", SPAN),
             ("sum:rate:1h-avg:bench.metric{host=h00001}", SPAN),
             ("p95:1h-avg:bench.metric{host=h00001}", SPAN)]
MESH_KERNELS = ("moment_combine", "tile_carries")
MESH_WHERE = {
    "moment_combine": ("mesh_combine.cu",
                       "opentsdb_tpu/parallel/sharded.py:114"),
    "tile_carries": ("mesh_combine.cu",
                     "opentsdb_tpu/parallel/timeshard.py:79")}
# The kernels' shapes on the scan legs (executor padding: groups and
# buckets to powers of two): (agg, D, C) of the moment combine and
# (mode, D, S) of the carries.
MESH_CASES = {
    ("moment_combine", "{host=*} week"):
        ("sum", MESH_D, _pad_size(SERIES + TELNET_SERIES)
         * _pad_size(SPAN // INTERVAL + 1)),
    ("moment_combine", "{dc=*} day"):
        ("sum", MESH_D, _pad_size(10) * _pad_size(DAY // INTERVAL + 1)),
    ("tile_carries", "{host=h00001} week"): (0, MESH_D, _pad_size(1)),
    # timeshard_rate's predecessor search: the same kernel's other mode,
    # at the same shape; no executor leg runs it.
    ("tile_carries", "timeshard_rate (mode 1)"): (1, MESH_D, _pad_size(1)),
}
MESH_FLOW_SERIES = 8


def mesh_launches() -> dict:
    return {"moment_combine": mesh_combine.moment_combine.launches,
            "tile_carries": mesh_combine.tile_carries.launches}


def zero_mesh_launches() -> None:
    mesh_combine.moment_combine.launches = 0
    mesh_combine.tile_carries.launches = 0


def mesh_partials(agg: str, D: int, C: int, seed: int) -> tuple:
    """[D, C] partial planes as a shard's group stage makes them (counts
    with empty cells, sums, centered m2, min, max, any flags), from a
    seed, on the card; the planes ``agg`` does not read are None."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 40, (D, C)).astype(np.float32)
    total = (rng.normal(100, 5, (D, C)) * n).astype(np.float32)
    m2 = (rng.random((D, C)) * n).astype(np.float32)
    mn = np.where(n > 0, rng.normal(90, 3, (D, C)), np.inf)
    mx = np.where(n > 0, rng.normal(110, 3, (D, C)), -np.inf)
    want = mesh_combine.needs(agg)
    planes = {"total": total, "m2": m2, "min": mn, "max": mx}
    dev = torch.device(DEVICE)
    out = [torch.from_numpy(n).to(dev)]
    for k in ("total", "m2", "min", "max"):
        out.append(torch.from_numpy(planes[k].astype(np.float32)).to(dev)
                   if k in want else None)
    out.append(torch.from_numpy((n > 0).astype(np.int32)).to(dev))
    return tuple(out)


def mesh_summaries(mode: int, D: int, S: int, seed: int) -> torch.Tensor:
    """[D, S, 4] int32 tile summaries (float values as their bits), some
    series absent from whole tiles."""
    rng = np.random.default_rng(seed)
    present = rng.random((D, S)) < 0.7
    rows = np.zeros((D, S, 4), np.int32)
    v = rng.normal(100, 5, (D, S, 2)).astype(np.float32).view(np.int32)
    if mode == 0:
        base = (np.arange(D) * 64)[:, None]
        rows[:, :, 0] = np.where(present, base + rng.integers(0, 64, (D, S)),
                                 -1)
        rows[:, :, 2] = np.where(present, base + rng.integers(0, 64, (D, S)),
                                 2**31 - 1)
        rows[:, :, 1], rows[:, :, 3] = v[:, :, 0], v[:, :, 1]
    else:
        rows[:, :, 0] = present
        rows[:, :, 1] = (np.arange(D) * 151200)[:, None] + rng.integers(
            0, 151200, (D, S))
        rows[:, :, 2] = v[:, :, 0]
    return torch.from_numpy(rows).to(DEVICE)


def mesh_kernel_phase() -> list:
    """The two combine kernels against their plain versions at the scan
    legs' shapes (MESH_CASES), bit for bit, timed as the kernel phase
    times the others. Inputs are made from a seed at those shapes; the
    mesh child holds the kernels bit for bit on the legs' own payloads.
    Bound: bytes (each plane the kernel reads, once; each output written
    once); no single PyTorch call computes either function."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=DEVICE)
    results = []
    for (name, stage), (a, D, X) in MESH_CASES.items():
        if name == "moment_combine":
            args = mesh_partials(a, D, X, seed=X)
            got = mesh_combine.moment_combine(*args, agg=a)
            want = mesh_combine.moment_combine_plain(*args, a)

            def fn(args=args, a=a):
                return mesh_combine.moment_combine(*args, agg=a)

            def plain(args=args, a=a):
                return mesh_combine.moment_combine_plain(*args, a)
            # The planes the aggregator reads, and the any flags.
            planes = len(mesh_combine.needs(a)) + 1
            nbytes = planes * 4 * D * X + 5 * X
            extra = {"agg": a, "D": D, "cells": X}
        else:
            rows = mesh_summaries(a, D, X, seed=X + a)
            got = (mesh_combine.tile_carries(rows, a),)
            want = (mesh_combine.tile_carries_plain(rows, a),)

            def fn(rows=rows, a=a):
                return mesh_combine.tile_carries(rows, a)

            def plain(rows=rows, a=a):
                return mesh_combine.tile_carries_plain(rows, a)
            nbytes = 16 * D * X * 2
            extra = {"mode": a, "D": D, "series": X}
        torch.cuda.synchronize()
        if not all(same_bits(g, w) for g, w in zip(got, want)):
            fail(f"{name} [{stage}]: the kernel and its plain version "
                 f"differ")
        b_ms, b_by = bound_ms(nbytes, D * X)
        res = {"name": name, "stage": stage, **extra, "bytes": nbytes,
               "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
               "library": NO_LIBRARY}
        results.append(time_case(res, fn, plain, None, flush))
    del flush
    torch.cuda.empty_cache()
    return results


def mesh_tap(calls: list):
    """Wrap the combine wrappers so each call's arguments are kept (for
    the bit-for-bit check on the legs' own payloads); returns the
    restore function."""
    orig_mc, orig_tc = mesh_combine.moment_combine, mesh_combine.tile_carries

    def mc(*args, agg):
        calls.append(("moment_combine", [None if x is None else x.clone()
                                         for x in args], agg))
        return orig_mc(*args, agg=agg)

    def tc(rows, mode):
        calls.append(("tile_carries", [rows.clone()], mode))
        return orig_tc(rows, mode)

    # The wrappers count their launches on the module's name, which is
    # the tap while it is in: it carries the counts and hands them back.
    mc.launches, tc.launches = orig_mc.launches, orig_tc.launches
    mesh_combine.moment_combine, mesh_combine.tile_carries = mc, tc

    def restore():
        orig_mc.launches, orig_tc.launches = mc.launches, tc.launches
        mesh_combine.moment_combine = orig_mc
        mesh_combine.tile_carries = orig_tc
    return restore


def mesh_checks(calls: list) -> list:
    """Each captured call's kernel against its plain version, bit for
    bit, and its shape against the kernel phase's cases (run after the
    tap is gone and the path's launches are read)."""
    out = []
    shapes = {(n, v[0], v[1], v[2]) for (n, _), v in MESH_CASES.items()}
    for name, args, a in calls:
        if name == "moment_combine":
            got = mesh_combine.moment_combine(*args, agg=a)
            want = mesh_combine.moment_combine_plain(*args, a)
            D, X = args[0].shape
        else:
            got = (mesh_combine.tile_carries(args[0], a),)
            want = (mesh_combine.tile_carries_plain(args[0], a),)
            D, X = args[0].shape[:2]
        torch.cuda.synchronize()
        equal = all(same_bits(g, w) for g, w in zip(got, want))
        if not equal:
            fail(f"{name} on a mesh leg's payload ({a}, {D} x {X}): the "
                 f"kernel and its plain version differ")
        out.append({"name": name, "arg": a, "D": D, "size": X,
                    "bit_equal": equal, "timed_shape": (name, a, D, X)
                    in shapes})
    return out


def mesh_flow(port: int, stop: threading.Event, sent: list) -> None:
    """Telnet puts of MESH_FLOW_SERIES series of ``mesh.flow`` until
    ``stop``: ten points a series a batch, each batch acknowledged."""
    t = BASE + SPAN
    while not stop.is_set():
        lines = [f"put mesh.flow {t + i} {i} host=f{s}"
                 for s in range(MESH_FLOW_SERIES) for i in range(10)]
        said = telnet(port, lines)
        if "put:" in said:
            fail(f"mesh flow puts answered: {said[:300]!r}")
        sent.append(len(lines))
        t += 10


def mesh_phase(ts: np.ndarray, vals: np.ndarray) -> dict:
    """The serving mesh in one process at full width (ROADMAP item 11a),
    5h of the module docstring: a TSDB with a MESH_D-shard resident hot
    set behind a daemon whose executor holds ``Mesh([cuda:0] * MESH_D)``.
    Resident legs (the ten /q shapes through _dw_sharded_stage, against
    REFERENCE), a live reshard to 2 and back to MESH_D while telnet puts
    flow (the answers unchanged, the flow's acknowledged points served
    resident), then the scan legs (the window set aside) against the same
    TSDB's single-device executor, the combine kernels launched on them
    and held bit for bit on their payloads."""
    t_phase = time.perf_counter()
    start, end = BASE, BASE + SPAN - 1
    out: dict = {"shards": MESH_D, "resident": {}, "scan": {},
                 "reshard": []}
    # The MESH_D logical shards folded host x series (tsd --mesh 2x2):
    # the series-sharded legs run over all of them, the expert dashboard
    # splits them by family.
    mesh = make_hybrid_mesh(*EXPERT_FOLD, devices=[DEVICE] * MESH_D)
    mesh_plane.set_mesh_devices(MESH_D)
    with tempfile.TemporaryDirectory() as d:
        tsdb = open_tsdb(Config(auto_create_metrics=True, port=0,
                                bind="127.0.0.1", device=DEVICE,
                                enable_sketches=False,
                                devwindow_shards=MESH_D,
                                expert_parallel=True),
                         os.path.join(d, "wal"))
        tune_for_ingest()
        dw = tsdb.devwindow
        if getattr(dw, "n_shards", 0) != MESH_D:
            fail("the mesh TSDB came up without a sharded hot set")
        ex = QueryExecutor(tsdb, mesh=mesh)
        daemon = Daemon(tsdb, ex)
        try:
            t0 = time.perf_counter()
            for s in range(SERIES):
                tsdb.add_batch("bench.metric", ts[s], vals[s],
                               series_tags(s))
            tsdb.store.wal_barrier()
            lines, _ = telnet_corpus_lines()
            said = telnet(daemon.port, lines)
            if "put:" in said:
                fail(f"mesh telnet ingest answered: {said[:300]!r}")
            dw.flush()
            points = SERIES * POINTS + len(lines)
            out["ingest"] = {"points": points,
                             "s": time.perf_counter() - t0,
                             "resident_points": dw.resident_points()}
            if out["ingest"]["resident_points"] != points:
                fail(f"the sharded window holds "
                     f"{out['ingest']['resident_points']} of {points}")
            log(f"mesh ingest: {points} points in "
                f"{out['ingest']['s']:.1f} s")

            # 1. Resident legs.
            ref = reference()
            answers = {}
            zero_launches()
            for expr in QUERIES + PCT_QUERIES:
                run, answers[expr] = http_resident(daemon.port, dw, ex,
                                                   expr, start, end)
                exact = expr.startswith("max")
                want = ref["resident"][expr]
                out["resident"][expr] = {
                    "ms": run["wall_ms"], "identical": answers[expr] == want,
                    "max_rel_diff": same_answer(expr, answers[expr], want,
                                                exact)}
            out["launches"] = {"resident": path_launches(
                "mesh resident path", KERNELS[:3])}
            health = http_json(daemon.port, "/healthz")
            queries = http_json(daemon.port, "/api/queries")["mesh"]
            if (health.get("mesh") or {}).get("width") != MESH_D \
                    or queries["devices"] != MESH_D \
                    or (queries["serving"] or {}).get("width") != MESH_D:
                fail(f"the mesh daemon reports {health.get('mesh')}, "
                     f"{queries}")
            out["healthz_mesh"] = health["mesh"]
            log(f"mesh resident legs against REFERENCE: "
                f"{json.dumps(out['resident'])}")

            # 2. Reshard while telnet puts flow.
            stop, sent = threading.Event(), []
            flow = threading.Thread(target=mesh_flow,
                                    args=(daemon.port, stop, sent))
            flow.start()
            try:
                while not sent:
                    time.sleep(0.05)
                for n in (2, MESH_D):
                    r0 = time.perf_counter()
                    status, body = http_get(
                        daemon.port, f"/api/mesh/reshard?shards={n}")
                    wall = (time.perf_counter() - r0) * 1e3
                    if status != 200:
                        fail(f"reshard to {n}: HTTP {status}: {body[:300]!r}")
                    got = json.loads(body)
                    if got["n_shards"] != n:
                        fail(f"reshard to {n} answered {got}")
                    out["reshard"].append({**got, "wall_ms": wall,
                                           "flow_batches": len(sent)})
                    log(f"reshard to {n}: {got} ({wall:.0f} ms wall)")
            finally:
                stop.set()
                flow.join()
            zero_launches()
            out["after_reshard"] = {}
            for expr in QUERIES + PCT_QUERIES:
                _, got = http_resident(daemon.port, dw, ex, expr, start,
                                       end)
                out["after_reshard"][expr] = same_answer(
                    expr, got, answers[expr], expr.startswith("max"))
            flow_points = sum(sent)
            _, got = http_resident(
                daemon.port, dw, ex, "zimsum:1h-count:mesh.flow",
                BASE + SPAN, BASE + SPAN + 10 * len(sent) + 10)
            served = sum(sum(g["dps"].values()) for g in got)
            if served != flow_points:
                fail(f"the flow's {flow_points} acknowledged points, "
                     f"{served} served resident after the reshards")
            out["flow"] = {"batches": len(sent), "points": flow_points,
                           "served_resident": served}
            health = http_json(daemon.port, "/healthz")["mesh"]
            if health["width"] != MESH_D or \
                    health["resident"]["reshards"] != 2:
                fail(f"after the reshards /healthz says {health}")

            # 3. Scan legs: the window set aside; each leg against the
            # same TSDB's single-device executor.
            # The counts are zeroed just before the mesh legs' /q and
            # read just after; the single-device answers come after that,
            # so the counts hold the mesh legs' launches and no others.
            plain = QueryExecutor(tsdb)
            calls: list = []
            mesh_got = {}
            tsdb.devwindow = None
            try:
                zero_launches()
                zero_mesh_launches()
                restore = mesh_tap(calls)
                try:
                    for expr, span in MESH_SCAN:
                        d0 = mesh_plane._M_DISPATCH.count
                        got, run, _ = http_union_any(
                            daemon.port, expr, start, start + span - 1)
                        dispatches = mesh_plane._M_DISPATCH.count - d0
                        if dispatches == 0:
                            fail(f"{expr}: not dispatched through the mesh")
                        mesh_got[expr] = (got, run["wall_ms"], dispatches)
                finally:
                    restore()
                out["launches"]["mesh"] = {**path_launches(
                    "mesh scan path", ("segment_sum", "masked_select")),
                    **mesh_launches()}
                for name in MESH_KERNELS:
                    if out["launches"]["mesh"][name] == 0:
                        fail(f"the mesh scan legs never launched {name}")
                for expr, span in MESH_SCAN:
                    got, wall_ms, dispatches = mesh_got[expr]
                    s0 = time.perf_counter()
                    want = plain.run(spec_of(expr), start, start + span - 1)
                    torch.cuda.synchronize()
                    single_ms = (time.perf_counter() - s0) * 1e3
                    err = check_answer(expr, got, want, 1e-5,
                                       "single-device executor")
                    out["scan"][expr] = {
                        "ms": wall_ms, "single_device_ms": single_ms,
                        "groups": len(got), "max_rel_err": err,
                        "dispatches": dispatches}
                    log(f"mesh scan leg {expr}: {wall_ms:.0f} ms "
                        f"(single-device {single_ms:.0f} ms), rel err "
                        f"{err:g}")
            finally:
                tsdb.devwindow = dw
            del mesh_got
            out["kernel_checks"] = mesh_checks(calls)
            del calls
            cache = http_json(daemon.port, "/api/queries")["mesh"][
                "compile_cache"]
            if cache["size"] < 1 or cache["miss"] < 1 \
                    or cache["devices"] != MESH_D:
                fail(f"the mesh daemon's compile cache: {cache}")
            out["compile_cache"] = cache

            # 4. The expert dashboard (5h).
            out["expert"] = expert_leg(daemon, tsdb, dw,
                                       int((ts < BASE + DAY).sum()))
            out["launches"]["expert"] = out["expert"].pop("launches")
            log(f"expert dashboard: {json.dumps({k: out['expert'][k] for k in ('expert_ms', 'scan_ms', 'resident_ms', 'against_scan', 'decline')})}")
        finally:
            daemon.stop()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh phase: {json.dumps({k: out[k] for k in ('launches', 'reshard', 'flow', 'compile_cache', 'phase_s')})}")
    return out


# ---------------------------------------------------------------------------
# Expert dashboard (in the mesh child) and the hybrid mesh and plane
# (fleet child): ROADMAP item 11b
# ---------------------------------------------------------------------------

# The mesh child's query mesh is folded host x series, as tsd --mesh 2x2.
EXPERT_FOLD = (2, 2)
# One /q over the corpus's first day: five {dc=*} panels at 1h, each dc
# group a slot (50 slots of ~143k points); the sixth, rate panel makes a
# second request decline.
EXPERT_PANELS = ["sum:1h-avg:bench.metric{dc=*}",
                 "max:1h-max:bench.metric{dc=*}",
                 "dev:1h-avg:bench.metric{dc=*}",
                 "p95:1h-avg:bench.metric{dc=*}",
                 "p50:1h-avg:bench.metric{dc=*}"]
EXPERT_DECLINE_PANEL = "sum:rate:1h-avg:bench.metric{dc=*}"
EXPERT_GROUPS = 10
EXPERT_REPS = 3
# The dashboard's [S, B] (executor padding) and the fleet phase's week.
EXPERT_GRID = (_pad_size(SERIES // EXPERT_GROUPS),
               _pad_size(DAY // INTERVAL + 1))
FLEET_B = _pad_size(SPAN // INTERVAL + 1)
EXPERT_KERNELS = ("dash_finish", "hybrid_moment_combine")
EXPERT_WHERE = {
    "dash_finish": ("expert.cu", "opentsdb_tpu/parallel/expert.py:400"),
    "hybrid_moment_combine": ("mesh_combine.cu",
                              "opentsdb_tpu/parallel/multihost.py:97")}
FLEET_AGGS = ("sum", "dev")
FLEET_HLL_REL_ERR = 0.05       # the JAX test's bound
MULTIHOST_WALL_S = 300.0


def expert_plan():
    """The dashboard's plan as the executor packs it (panel by panel, one
    slot a dc group), from one-point stand-in slots: the shards'
    families and their slots' aggregator codes."""
    queries = []
    for expr in EXPERT_PANELS:
        p = parse_m(expr)
        agg = Aggregators.get(p.aggregator)
        for _ in range(EXPERT_GROUPS):
            q = {"family": ("percentile" if agg.kind == "percentile"
                            else "moment"), "ts": [0], "vals": [0.0],
                 "sid": [0], "dsagg": p.downsample[1]}
            if agg.kind == "percentile":
                q["quantile"] = agg.quantile
            else:
                q["agg"] = p.aggregator
            queries.append(q)
    return pexpert.plan_dashboard_batch(queries, MESH_D)


def dash_cases() -> dict:
    """dash_finish's cases at the dashboard's shapes, the day (B = 32)
    and the week (B = 256): stage -> (downsampler codes, group
    aggregator codes or None for a percentile shard's fill, S, B), with
    the plan's codes of a moment and a percentile shard."""
    plan = expert_plan()
    S, B = EXPERT_GRID
    m = int(np.flatnonzero(plan.fam == 0)[0])
    p = int(np.flatnonzero(plan.fam == 1)[0])
    Q = plan.ds_id.shape[1]
    out = {}
    for when, b in (("day", B), ("week", FLEET_B)):
        out[f"{when}, moment shard ({Q} x {S:,} x {b})"] = (
            [int(c) for c in plan.ds_id[m]],
            [int(c) for c in plan.agg_id[m]], S, b)
        out[f"{when}, percentile shard, fill ({Q} x {S:,} x {b})"] = (
            [int(c) for c in plan.ds_id[p]], None, S, b)
    return out


def dash_planes(ds: list, S: int, B: int, seed: int) -> tuple:
    """A shard's series stage on the card as the dashboard's makes it
    (``_dash_series_stage``: strided [Q, S * B] views): each slot a dc
    group's SERIES // EXPERT_GROUPS series with the corpus's points per
    series over B buckets' span (a day: ~143 points over 25 of the 32
    buckets; a week: POINTS over 169 of 256), the padding series empty;
    values a random walk's spread, drawn from ``seed`` on the card."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    Q, real = len(ds), SERIES // EXPERT_GROUPS
    span, per = (DAY, POINTS * DAY // SPAN) if B == EXPERT_GRID[1] \
        else (SPAN, POINTS)
    n = real * per
    ts = torch.randint(0, span, (Q, n), generator=g, device=dev,
                       dtype=torch.int32)
    sid = torch.arange(real, device=dev, dtype=torch.int32) \
        .repeat_interleave(per)[None].expand(Q, n).contiguous()
    vals = (100.0 + 10.0 * torch.randn((Q, n), generator=g, device=dev))
    valid = torch.ones((Q, n), dtype=torch.bool, device=dev)
    return pexpert._dash_series_stage(ts, vals, sid, valid, ds,
                                      num_series=S, num_buckets=B,
                                      interval=INTERVAL)


def dash_compare(got, want, agg) -> float:
    """The fused finish against its plain version: a fill (``agg``
    None) and the group masks bit for bit, the min / max / count slots'
    values bit for bit, sums, averages and deviations within rtol 1e-5 +
    1e-5 x scale (the kernel sums over the series in its own order).
    Returns the largest absolute difference."""
    torch.cuda.synchronize()
    if agg is None:
        if not all(same_bits(a, b) for a, b in zip(got, want)):
            fail("dash_finish (fill): the kernel and its plain version "
                 "differ")
        return 0.0
    if not same_bits(got[1], want[1]):
        fail("dash_finish: the group masks differ")
    err = 0.0
    for q, code in enumerate(agg):
        a, b = got[0][q].double(), want[0][q].double()
        if code in (1, 2, 5):
            if not same_bits(got[0][q], want[0][q]):
                fail(f"dash_finish: slot {q} ({expert_finish.DASH_AGGS[code]})"
                     f" differs from its plain version")
            continue
        fin = torch.isfinite(b)
        scale = float(b[fin].abs().max()) if bool(fin.any()) else 1.0
        d = (a - b).abs().nan_to_num(0.0)
        if bool((d > 1e-5 * b.abs() + 1e-5 * scale).any()) or not \
                torch.equal(torch.isnan(a), torch.isnan(b)):
            fail(f"dash_finish: slot {q} ({expert_finish.DASH_AGGS[code]}) "
                 f"off its plain version by {float(d.max())}")
        err = max(err, float(d.max()))
    return err


def dash_attribution(planes, ds, agg, kw) -> dict:
    """Where a dash_finish call's device time goes: the same call with
    one slot (the slots' clusters run side by side, so a time near the
    whole call's says a slot's chain of steps, not the card's width,
    sets it), without a second pass (every dev group aggregator taken as
    sum), and the codes' upload alone (``ms_device`` each)."""
    def one():
        return expert_finish.dash_finish(
            *(None if p is None else p[:1] for p in planes), ds[:1],
            None if agg is None else agg[:1], **kw)

    no_dev = None if agg is None else [0 if c == 4 else c for c in agg]

    def no_dev_pass():
        return expert_finish.dash_finish(*planes, ds, no_dev, **kw)

    def upload():
        return torch.tensor(ds + (agg or [0] * len(ds)),
                            dtype=torch.int32).to(DEVICE, non_blocking=True)
    out = {"one_slot_ms_device": device_ms(one),
           "codes_upload_ms_device": device_ms(upload)}
    if agg is not None and 4 in agg:
        out["no_dev_pass_ms_device"] = device_ms(no_dev_pass)
    log(f"kernel dash_finish attribution: {out}")
    return out


def dash_chain(planes, ds, agg, S, B):
    """What the fused kernel replaced, through the same ported pieces:
    the per-cell finish kernel by the downsamplers, ``gap_fill`` over the
    [Q * S, B] rows, then (a moment shard) ``group_moments`` over the
    [S, Q * B] view and the per-cell finish by the group aggregators."""
    Q = len(ds)
    per = expert_finish.finish_cells(*planes, ds)
    sm = (planes[0] > 0).reshape(Q * S, B)
    filled, in_range = wk.gap_fill(per.reshape(Q * S, B), sm, B)
    gm = sm.reshape(Q, S, B).any(dim=1)
    if agg is None:
        return filled.reshape(Q, S, B), in_range.reshape(Q, S, B), gm
    f2 = filled.reshape(Q, S, B).permute(1, 0, 2).reshape(S, Q * B)
    r2 = in_range.reshape(Q, S, B).permute(1, 0, 2).reshape(S, Q * B)
    g_n, g_total, g_m2, _, g_mn, g_mx = wk.group_moments(f2, r2)
    return expert_finish.finish_cells(
        *(x.reshape(Q, B) for x in (g_n, g_total, g_m2, g_mn, g_mx)),
        agg), gm


def hybrid_partials(H: int, C: int, cells: int, seed: int) -> list:
    """[H, C, cells] partials as a shard's group stage makes them, on the
    card (dev reads every plane)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 400, (H, C, cells)).astype(np.float32)
    total = (rng.normal(100, 5, (H, C, cells)) * n).astype(np.float32)
    mean = total / np.maximum(n, 1)
    m2 = (rng.random((H, C, cells)) * n * 30).astype(np.float32)
    mn = np.where(n > 0, rng.normal(90, 3, (H, C, cells)), np.inf)
    mx = np.where(n > 0, rng.normal(110, 3, (H, C, cells)), -np.inf)
    return [torch.from_numpy(np.asarray(x, np.float32)).to(DEVICE)
            for x in (n, total, m2, mean, mn, mx)] + [
        torch.from_numpy((n > 0).astype(np.int32)).to(DEVICE)]


def hybrid_stages() -> dict:
    H, C = EXPERT_FOLD
    return {"finish": f"week group, finish ({H} x {C} x {FLEET_B})",
            "emit": f"week group, a row's emit (1 x {C} x {FLEET_B})",
            "gathered": f"week group, finish of the gathered rows "
                        f"({H} x 1 x {FLEET_B})"}


def expert_kernel_phase() -> list:
    """dash_finish at the dashboard's shapes (a moment shard's whole
    finish and a percentile shard's fill, at the day and the week, with
    the plan's codes, over a series stage made on the card), each held
    against its plain version (``dash_compare``), timed as the kernel
    phase times the others and, in the same call, A B B A against the
    chain it replaced (``dash_chain``: ``same_call``, device time); and
    hybrid_moment_combine at the fleet phase's week group (the one-launch
    finish over [2, 2, B], one row's emit over [1, 2, B] and the finish
    of the gathered rows over [2, 1, B], which must equal the one-launch
    finish bit for bit) against its plain version bit for bit. Inputs
    are made from a seed at those shapes; the children hold the kernels
    on the paths' own payloads. Bound: bytes (each plane a slot or the
    aggregator reads, once; each output written once; dash_finish's
    operations, ~12 a cell, bind at 1/100 of that); no single PyTorch
    call computes either function."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=DEVICE)
    results = []
    for i, (stage, (ds, agg, S, B)) in enumerate(dash_cases().items()):
        planes = dash_planes(ds, S, B, seed=100 + i)
        kw = dict(num_series=S, num_buckets=B)
        err = dash_compare(
            expert_finish.dash_finish(*planes, ds, agg, **kw),
            expert_finish.dash_finish_plain(*planes, ds, agg, **kw), agg)

        def fn(planes=planes, ds=ds, agg=agg, kw=kw):
            return expert_finish.dash_finish(*planes, ds, agg, **kw)

        def plain(planes=planes, ds=ds, agg=agg, kw=kw):
            return expert_finish.dash_finish_plain(*planes, ds, agg, **kw)

        def chain(planes=planes, ds=ds, agg=agg, S=S, B=B):
            return dash_chain(planes, ds, agg, S, B)
        fill = agg is None
        nbytes = expert_finish.dash_bytes(ds, fill, S, B)
        b_ms, b_by = bound_ms(nbytes, 12 * len(ds) * S * B)
        res = {"name": "dash_finish", "stage": stage, "slots": len(ds),
               "S": S, "B": B, "ds_codes": ds, "agg_codes": agg,
               "bytes": nbytes, "max_abs_err": err, "bound_ms": b_ms,
               "bound_by": b_by, "library": NO_LIBRARY}
        time_case(res, fn, plain, None, flush)
        turns = [device_ms(f) for f in (fn, chain, chain, fn)]
        res["same_call"] = {
            "order": "fused, chain, chain, fused (device ms)",
            "fused_ms_device": [turns[0], turns[3]],
            "chain_ms_device": [turns[1], turns[2]],
            "chain_launches": "per-cell finish, gap_fill, "
                              + ("" if fill else "group_moments, per-cell "
                                 "finish, ") + "their torch ops"}
        log(f"kernel dash_finish [{stage}]: same call fused "
            f"{turns[0]:.4f} / {turns[3]:.4f} ms, chain {turns[1]:.4f} / "
            f"{turns[2]:.4f} ms (device)")
        res["attribution"] = dash_attribution(planes, ds, agg, kw)
        results.append(res)
        del planes
    H, C = EXPERT_FOLD
    agg = "dev"
    planes = hybrid_partials(H, C, FLEET_B, seed=7)
    need = len(mesh_combine.hybrid_needs(agg)) + 1      # and any
    rows = [mesh_combine.hybrid_moment_combine(
        *(p[h:h + 1] for p in planes), agg=agg, emit=True)
        for h in range(H)]
    gathered = [None if rows[0][i] is None else
                torch.cat([r[i] for r in rows])[:, None] for i in range(7)]
    stages = hybrid_stages()
    cases = {
        "finish": (planes, False, need * 4 * H * C * FLEET_B
                   + 5 * FLEET_B),
        "emit": ([p[:1] for p in planes], True,
                 need * 4 * C * FLEET_B + need * 4 * FLEET_B),
        "gathered": (gathered, False, need * 4 * H * FLEET_B + 5 * FLEET_B)}
    finished = None
    for key, (args, emit, nbytes) in cases.items():
        got = mesh_combine.hybrid_moment_combine(*args, agg=agg, emit=emit)
        want = mesh_combine.hybrid_moment_combine_plain(*args, agg, emit)
        torch.cuda.synchronize()
        if not all(same_bits(g, w) for g, w in zip(got, want)
                   if g is not None):
            fail(f"hybrid_moment_combine [{stages[key]}]: the kernel and "
                 f"its plain version differ")
        if key == "finish":
            finished = got
        elif key == "gathered" and not all(
                same_bits(a, b) for a, b in zip(got, finished)):
            fail("hybrid_moment_combine: emit then finish differs from the "
                 "one-launch finish")

        def fn(args=args, emit=emit):
            return mesh_combine.hybrid_moment_combine(*args, agg=agg,
                                                      emit=emit)

        def plain(args=args, emit=emit):
            return mesh_combine.hybrid_moment_combine_plain(*args, agg,
                                                            emit)
        b_ms, b_by = bound_ms(nbytes, H * C * FLEET_B)
        res = {"name": "hybrid_moment_combine", "stage": stages[key],
               "agg": agg, "emit": emit, "bytes": nbytes,
               "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
               "library": NO_LIBRARY}
        results.append(time_case(res, fn, plain, None, flush))
    del flush
    torch.cuda.empty_cache()
    return results


def dash_q(port: int, panels: list, start: int, end: int) -> tuple:
    """One dashboard /q (every panel an m=): (answer, wall ms)."""
    target = "/q?" + urllib.parse.urlencode(
        [("start", start), ("end", end)] + [("m", m) for m in panels]
        + [("json", "")])
    q0 = time.perf_counter()
    status, body = http_get(port, target)
    wall = (time.perf_counter() - q0) * 1e3
    if status != 200:
        fail(f"dashboard /q: HTTP {status}: {body[:300]!r}")
    return json.loads(body), wall


def finish_tap(calls: list):
    """Keep each dash_finish call's arguments (the expert body calls it
    through its module's name); returns the restore function. Launches
    still count on the wrapper."""
    orig = pexpert.dash_finish

    def tap(*args, num_series, num_buckets):
        planes, ds = args[:5], args[5]
        agg = args[6] if len(args) > 6 else None
        calls.append(([None if p is None else p.clone() for p in planes],
                      list(ds), None if agg is None else list(agg),
                      num_series, num_buckets))
        return orig(*args, num_series=num_series, num_buckets=num_buckets)
    pexpert.dash_finish = tap

    def restore():
        pexpert.dash_finish = orig
    return restore


def finish_checks(calls: list) -> list:
    """Each captured dash_finish call against its plain version
    (``dash_compare``), and its shape and codes against the kernel
    phase's cases."""
    shapes = {(tuple(ds), None if agg is None else tuple(agg), S, B)
              for ds, agg, S, B in dash_cases().values()}
    out = []
    for planes, ds, agg, S, B in calls:
        kw = dict(num_series=S, num_buckets=B)
        err = dash_compare(
            expert_finish.dash_finish(*planes, ds, agg, **kw),
            expert_finish.dash_finish_plain(*planes, ds, agg, **kw), agg)
        out.append({"slots": len(ds), "S": S, "B": B, "ds_codes": ds,
                    "agg_codes": agg, "max_abs_err": err,
                    "timed_shape": (tuple(ds), None if agg is None
                                    else tuple(agg), S, B) in shapes})
    return out


def dash_answers_compare(got: list, want: list, what: str) -> dict:
    """A dashboard's answers against another path's: the same groups,
    tags and timestamps panel by panel; max exactly, sums and deviations
    within rtol 1e-5 + 1e-5 x scale (the segment sums add in another
    order), percentiles the same rank selections over the same filled
    grid, at the same tolerance (their grid's sums may differ by an ulp:
    ``identical`` says whether they did). Returns per panel the largest
    relative-to-scale difference and the identical group count."""
    if len(got) != len(want) or len(got) % EXPERT_GROUPS:
        fail(f"{what}: {len(got)} results against {len(want)}")
    out = {}
    for i in range(len(got) // EXPERT_GROUPS):
        expr = (EXPERT_PANELS + [EXPERT_DECLINE_PANEL])[i]
        worst, same = 0.0, 0
        for g, w in zip(got[i * EXPERT_GROUPS:(i + 1) * EXPERT_GROUPS],
                        want[i * EXPERT_GROUPS:(i + 1) * EXPERT_GROUPS]):
            if g["tags"] != w["tags"] or list(g["dps"]) != list(w["dps"]) \
                    or g["aggregateTags"] != w["aggregateTags"]:
                fail(f"{what}, {expr}: tags or timestamps differ")
            a = np.array(list(g["dps"].values()), np.float64)
            b = np.array(list(w["dps"].values()), np.float64)
            if not len(a) or not np.isfinite(a).all():
                fail(f"{what}, {expr}: empty or non-finite answer")
            scale = max(float(np.abs(b).max()), 1e-30)
            err = np.abs(a - b)
            if expr.startswith("max") and (a != b).any():
                fail(f"{what}, {expr}: max differs")
            if (err > 1e-5 * np.abs(b) + 1e-5 * scale).any():
                j = int(np.argmax(err))
                fail(f"{what}, {expr}: {a[j]!r} against {b[j]!r}")
            worst = max(worst, float(err.max() / scale))
            same += bool((a == b).all())
        out[expr] = {"max_rel_diff": worst, "identical_groups": same}
    return out


def expert_leg(daemon: "Daemon", tsdb: TSDB, dw, day_points: int) -> dict:
    """The expert dashboard on the mesh daemon (``--expert-parallel``,
    the executor's mesh folded 2 x 2): the five panels through the
    expert path (its launches counted on the first run alone, every
    dash_finish payload held bit for bit), then the same /q served
    serially on the scan path (expert off, window set aside) and from
    the resident window (expert off), every expert answer held against
    the serial scan's; then the sixth, rate panel must decline the whole
    request (``expert-decline``, counted) with the five panels' answers
    unchanged."""
    start, end = BASE, BASE + DAY - 1
    server = daemon.server
    port = daemon.port
    out: dict = {"panels": EXPERT_PANELS, "fold": list(EXPERT_FOLD),
                 "grid": list(EXPERT_GRID)}
    calls: list = []
    server.expert_enabled = True
    serve0 = METRICS.counter("mesh.expert.serve").value
    zero_launches()
    expert_finish.dash_finish.launches = 0
    restore = finish_tap(calls)
    try:
        answer, ms = dash_q(port, EXPERT_PANELS, start, end)
    finally:
        restore()
    counts = dict(zip(KERNELS, launches()),
                  dash_finish=expert_finish.dash_finish.launches)
    for name in ("dash_finish", "segment_sum", "masked_select"):
        if counts[name] == 0:
            fail(f"the expert dashboard never launched {name}")
    if counts["dash_finish"] != MESH_D:
        fail(f"the expert dashboard's {MESH_D} shards launched dash_finish "
             f"{counts['dash_finish']} times, not once each")
    out["launches"] = counts
    if len(answer) != len(EXPERT_PANELS) * EXPERT_GROUPS or any(
            r.get("plan") != "expert" or r["rollup"] != "expert"
            for r in answer):
        fail(f"the dashboard did not serve through the expert path: "
             f"{[(r.get('plan'), r['rollup']) for r in answer][:6]}")
    if METRICS.counter("mesh.expert.serve").value - serve0 != \
            len(EXPERT_PANELS):
        fail("mesh.expert.serve did not count the dashboard's panels")
    out["expert_ms"] = [ms] + [dash_q(port, EXPERT_PANELS, start, end)[1]
                               for _ in range(EXPERT_REPS - 1)]
    server.expert_enabled = False
    tsdb.devwindow = None
    try:
        scan = [dash_q(port, EXPERT_PANELS, start, end)
                for _ in range(EXPERT_REPS)]
        server.expert_enabled = True
        d0 = METRICS.counter("mesh.expert.decline",
                             {"reason": "rate"}).value
        declined, declined_ms = dash_q(
            port, EXPERT_PANELS + [EXPERT_DECLINE_PANEL], start, end)
        declines = METRICS.counter("mesh.expert.decline",
                                   {"reason": "rate"}).value - d0
    finally:
        tsdb.devwindow = dw
        server.expert_enabled = False
    if any(r["rollup"] != "raw" or "plan" in r for r in scan[0][0]):
        fail("the serial dashboard did not take the scan path")
    resident = [dash_q(port, EXPERT_PANELS, start, end)
                for _ in range(EXPERT_REPS)]
    server.expert_enabled = True
    if any(r["rollup"] != "resident" for r in resident[0][0]):
        fail("the serial dashboard did not serve resident")
    out["scan_ms"] = [m for _, m in scan]
    out["resident_ms"] = [m for _, m in resident]
    out["against_scan"] = dash_answers_compare(answer, scan[0][0],
                                              "expert vs scan")
    out["resident_against_scan"] = dash_answers_compare(
        resident[0][0], scan[0][0], "resident vs scan")
    n6 = (len(EXPERT_PANELS) + 1) * EXPERT_GROUPS
    if len(declined) != n6 or any(r.get("plan") != "expert-decline"
                                  for r in declined):
        fail("the rate panel's dashboard did not declare its decline")
    if declines != len(EXPERT_PANELS) + 1:
        fail(f"mesh.expert.decline{{reason=rate}} counted {declines}")
    out["decline"] = {
        "reason": "rate", "counted": declines, "ms": declined_ms,
        "panels_against_scan": dash_answers_compare(
            declined[:len(scan[0][0])], scan[0][0], "declined vs scan")}
    out["kernel_checks"] = finish_checks(calls)
    del calls
    out["slots"] = len(EXPERT_PANELS) * EXPERT_GROUPS
    out["corpus_points_per_slot"] = day_points // EXPERT_GROUPS
    return out


def hybrid_tap(calls: list):
    """Keep each hybrid_moment_combine call's arguments; returns the
    restore function (the wrapper counts its launches on the module's
    name, which is the tap while it is in, as in ``mesh_tap``)."""
    orig = mesh_combine.hybrid_moment_combine

    def tap(*args, agg, emit=False):
        calls.append(([None if x is None else x.clone() for x in args], agg,
                      emit))
        return orig(*args, agg=agg, emit=emit)
    tap.launches = orig.launches
    mesh_combine.hybrid_moment_combine = tap

    def restore():
        orig.launches = tap.launches
        mesh_combine.hybrid_moment_combine = orig
    return restore


def hybrid_checks(calls: list) -> list:
    """Each captured one-launch finish against its plain version bit for
    bit, and against the cross-process sequence on the same partials
    (each row's emit, the rows gathered, the finish over [H, 1, cells]):
    the same bits."""
    out = []
    for args, agg, emit in calls:
        got = mesh_combine.hybrid_moment_combine(*args, agg=agg, emit=emit)
        want = mesh_combine.hybrid_moment_combine_plain(*args, agg, emit)
        torch.cuda.synchronize()
        if not all(same_bits(g, w) for g, w in zip(got, want)
                   if g is not None):
            fail(f"hybrid_moment_combine ({agg}) on the fleet phase's "
                 f"payload: the kernel and its plain version differ")
        H = args[6].shape[0]
        rows = [mesh_combine.hybrid_moment_combine(
            *(None if x is None else x[h:h + 1] for x in args), agg=agg,
            emit=True) for h in range(H)]
        again = mesh_combine.hybrid_moment_combine(
            *(None if rows[0][i] is None else
              torch.cat([r[i] for r in rows])[:, None] for i in range(7)),
            agg=agg)
        torch.cuda.synchronize()
        two_level = all(same_bits(a, b) for a, b in zip(again, got))
        if not two_level:
            fail(f"hybrid_moment_combine ({agg}): emit then finish differs "
                 f"from the one-launch finish")
        out.append({"agg": agg, "shape": list(args[6].shape),
                    "bit_equal": True, "emit_then_finish_equal": two_level})
    return out


MIXED_SLOTS = 4            # queries a family in the research batch
MIXED_VALUES = 8_000       # values a percentile query (one fold row)


@contextlib.contextmanager
def plain_body_kernels():
    """A body's kernels replaced by their plain versions (the segment
    kernels through ``ops/kernels.py``, the sketch kernels through
    ``ops/sketches.py``): the body's plain version, for timing beside
    it."""
    saved = (wk.segment_sum, wk.segment_minmax, sketches.hll_fold,
             sketches.hll_estimate, sketches.tdigest_fold)
    wk.segment_sum = segment_reduce.segment_sum_plain
    wk.segment_minmax = segment_reduce.segment_minmax_plain
    sketches.hll_fold = sketches.hll_fold_plain
    sketches.hll_estimate = sketches.hll_estimate_plain
    sketches.tdigest_fold = (
        lambda means, weights, idx, batch, valid=None,
        batch_weights=None, *, compression: sketches.tdigest_fold_plain(
            means, weights, idx, batch, valid, batch_weights,
            compression=compression))
    try:
        yield
    finally:
        (wk.segment_sum, wk.segment_minmax, sketches.hll_fold,
         sketches.hll_estimate, sketches.tdigest_fold) = saved


def body_bound(arrays) -> dict:
    """A whole body's bound: its inputs read once (its outputs are a few
    numbers a query); bytes over the HBM rate."""
    nbytes = sum(np.asarray(a).nbytes for a in arrays)
    b_ms, b_by = bound_ms(nbytes, 0)
    return {"bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
            "library": NO_LIBRARY}


def wall_ms(fn) -> float:
    """One call's wall ms, the card synchronized after it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def mixed_batch_case(ts: np.ndarray, vals: np.ndarray) -> dict:
    """The research face (``run_mixed_batch``, which no daemon calls) on
    the four logical shards: MIXED_SLOTS moment queries (ten series' day
    each), percentile queries (MIXED_VALUES values) and cardinality
    queries (a day's timestamps), against the same batch on the CPU:
    moments at float32 tolerance, quantiles within 1% of the value
    range (two digest builds), estimates within 1e-6; a percentile shard
    folds its slots in one launch, a cardinality shard in one fold and
    one estimate."""
    spec = pexpert.ExpertSpecs(
        moment=pexpert.MomentSpec(num_series=16, num_buckets=32,
                                  interval=INTERVAL, agg_down="avg",
                                  agg_group="sum"),
        percentile=pexpert.PercentileSpec(qs=tuple(SKETCH_QS)))
    queries = []
    for i in range(MIXED_SLOTS):
        rows = slice(10 * i, 10 * i + 10)
        day = ts[rows] < BASE + DAY
        queries.append({
            "family": "moment", "ts": (ts[rows][day] - BASE).astype(np.int32),
            "vals": vals[rows][day],
            "sid": np.repeat(np.arange(10, dtype=np.int32),
                             day.sum(axis=1))})
        queries.append({"family": "percentile",
                        "vals": vals[i, :].repeat(8)[:MIXED_VALUES]})
        queries.append({"family": "cardinality",
                        "items": (ts[rows][day] - BASE).astype(np.int32)})
    before = {n: getattr(sketches, n).launches
              for n in ("tdigest_fold", "hll_fold", "hll_estimate")}
    t0 = time.perf_counter()
    got = pexpert.run_mixed_batch(queries, Mesh([DEVICE] * MESH_D), spec)
    ms = (time.perf_counter() - t0) * 1e3
    launches = {n: getattr(sketches, n).launches - v
                for n, v in before.items()}
    want = pexpert.run_mixed_batch(queries, Mesh(["cpu"] * MESH_D), spec)
    plan = pexpert.plan_expert_batch(queries, MESH_D)
    shards = {f: int((plan.fam == i).sum())
              for i, f in enumerate(pexpert.FAMILIES)}
    if launches != {"tdigest_fold": shards["percentile"],
                    "hll_fold": shards["cardinality"],
                    "hll_estimate": shards["cardinality"]}:
        fail(f"the mixed batch launched {launches} for shards {shards}")
    worst = {"moment": 0.0, "percentile": 0.0, "cardinality": 0.0}
    for q, g, w in zip(queries, got, want):
        g, w = np.atleast_1d(g), np.atleast_1d(w)
        if q["family"] == "moment":
            if not np.array_equal(np.isnan(g), np.isnan(w)):
                fail("mixed batch: a moment query's mask differs")
            g, w = g[~np.isnan(g)], w[~np.isnan(w)]
            scale = float(np.abs(w).max())
            err = float(np.abs(g - w).max() / scale)
            bound = 1e-5 + 1e-5
        elif q["family"] == "percentile":
            span = float(np.ptp(q["vals"]))
            err = float(np.abs(g - w).max() / span)
            bound = 0.01
        else:
            err = float(abs(g[0] - w[0]) / w[0])
            bound = 1e-6
        if err > bound:
            fail(f"mixed batch: a {q['family']} query differs from the "
                 f"CPU's by {err}")
        worst[q["family"]] = max(worst[q["family"]], err)
    mesh = Mesh([DEVICE] * MESH_D)
    with plain_body_kernels():
        plain_ms = wall_ms(lambda: pexpert.run_mixed_batch(queries, mesh,
                                                           spec))
    inputs = [a for q in queries for k, a in q.items() if k != "family"]
    return {"queries": len(queries), "shards": shards, "ms": ms,
            "launches": launches, "max_err": worst, "plain_ms": plain_ms,
            **body_bound(inputs)}


FLEET_KERNELS = ("hybrid_moment_combine", "segment_sum", "hll_fold",
                 "hll_estimate", "tdigest_fold")


def fleet_launches() -> dict:
    return {"hybrid_moment_combine":
            mesh_combine.hybrid_moment_combine.launches,
            "segment_sum": segment_reduce.segment_sum.launches,
            "segment_minmax": segment_reduce.segment_minmax.launches,
            "hll_fold": sketches.hll_fold.launches,
            "hll_estimate": sketches.hll_estimate.launches,
            "tdigest_fold": sketches.tdigest_fold.launches}


def fleet_phase(ts: np.ndarray, vals: np.ndarray) -> dict:
    """The hybrid mesh and the mesh plane (ROADMAP item 11b), 5i of the
    module docstring, in a child process beside the path phase: the
    three hybrid bodies over the corpus's week (10M points, 2,500 series
    a shard) on ``Mesh([cuda:0] * 4)`` folded 2 x 2, their launches
    counted, each answer held against the single-device kernels or the
    exact values, every hybrid combine payload held bit for bit (and the
    cross-process sequence on it); then ``tools/multihost_run.py
    --device cuda`` in its default mode and ``--serve``: two gloo
    processes on the card, their cross-process answers bit for bit
    against one process's."""
    t_phase = time.perf_counter()
    H, C = EXPERT_FOLD
    out: dict = {"fold": [H, C], "points": int(ts.size)}
    mesh = make_hybrid_mesh(H, C, devices=[DEVICE] * (H * C))
    series = [(ts[s] - BASE, vals[s]) for s in range(SERIES)]
    st, sv, ssid, svalid, sps = pack_shards(series, H * C)
    del series
    out["series_per_shard"] = sps
    calls: list = []
    zero_launches()
    mesh_combine.hybrid_moment_combine.launches = 0
    sketches.hll_fold.launches = 0
    sketches.hll_estimate.launches = 0
    sketches.tdigest_fold.launches = 0
    restore = hybrid_tap(calls)
    got: dict = {}
    try:
        for agg in FLEET_AGGS:
            t0 = time.perf_counter()
            gv, gm = hybrid_downsample_group(
                st, sv, ssid, svalid, mesh=mesh, series_per_shard=sps,
                num_buckets=FLEET_B, interval=INTERVAL, agg_down="avg",
                agg_group=agg)
            got[agg] = (gv.cpu().numpy(), gm.cpu().numpy(),
                        (time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        est = float(hybrid_hll_distinct(st, svalid, mesh=mesh, p=14))
        hll_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        tq = hybrid_tdigest(sv, svalid, SKETCH_QS, mesh=mesh).cpu().numpy()
        td_ms = (time.perf_counter() - t0) * 1e3
    finally:
        restore()
    out["launches"] = fleet_launches()
    for name in FLEET_KERNELS:
        if out["launches"][name] == 0:
            fail(f"the hybrid bodies never launched {name}")
    # The references, after the counts are read.
    flat_ts = torch.from_numpy((ts - BASE).astype(np.int32).ravel()) \
        .to(DEVICE)
    flat_vals = torch.from_numpy(vals.ravel()).to(DEVICE)
    flat_sid = torch.from_numpy(np.repeat(
        np.arange(SERIES, dtype=np.int32), POINTS)).to(DEVICE)
    valid = torch.ones_like(flat_sid, dtype=torch.bool)
    out["group"] = {}
    for agg in FLEET_AGGS:
        ref = wk.downsample_group(
            flat_ts, flat_vals, flat_sid, valid,
            num_series=_pad_size(SERIES), num_buckets=FLEET_B,
            interval=INTERVAL, agg_down="avg", agg_group=agg)
        gv, gm, ms = got[agg]
        wm = ref["group_mask"].cpu().numpy()
        wv = ref["group_values"].cpu().numpy()
        if not np.array_equal(gm, wm):
            fail(f"hybrid group ({agg}): mask differs from the "
                 f"single-device kernels'")
        scale = float(np.abs(wv[wm]).max())
        err = np.abs(gv[gm].astype(np.float64) - wv[wm])
        if (err > 1e-5 * np.abs(wv[wm]) + 1e-5 * scale).any():
            fail(f"hybrid group ({agg}): values differ from the "
                 f"single-device kernels'")
        out["group"][agg] = {"ms": ms, "buckets": int(gm.sum()),
                             "max_rel_err": float(err.max() / scale)}
    del flat_ts, flat_vals, flat_sid, valid
    exact = len(np.unique(st[svalid]))
    hll_rel = abs(est - exact) / exact
    if hll_rel > FLEET_HLL_REL_ERR:
        fail(f"hybrid HLL: {est} against {exact} distinct")
    ordered = np.sort(vals.ravel())
    rank = max(rank_error(ordered, float(v), q) for v, q in
               zip(tq, SKETCH_QS))
    if rank > SKETCH_RANK_TOL:
        fail(f"hybrid t-digest: rank error {rank}")
    del ordered
    with plain_body_kernels():
        hll_plain = wall_ms(lambda: hybrid_hll_distinct(st, svalid,
                                                        mesh=mesh, p=14))
        td_plain = wall_ms(lambda: hybrid_tdigest(sv, svalid, SKETCH_QS,
                                                  mesh=mesh))
    out["hll"] = {"ms": hll_ms, "estimate": est, "exact": exact,
                  "rel_err": hll_rel, "plain_ms": hll_plain,
                  **body_bound([st, svalid])}
    out["tdigest"] = {"ms": td_ms, "plain_ms": td_plain, "qs": SKETCH_QS,
                      **body_bound([sv, svalid]),
                      "quantiles": tq.tolist(), "max_rank_err": rank}
    out["kernel_checks"] = hybrid_checks(calls)
    del calls
    out["mixed_batch"] = mixed_batch_case(ts, vals)
    log(f"fleet in-process: {json.dumps({k: out[k] for k in ('launches', 'group', 'hll', 'tdigest')})}")
    out["multihost"] = {}
    for mode in ("hybrid", "serve"):
        t0 = time.perf_counter()
        rec = multihost_run.run_parent(mode, DEVICE, None,
                                       wall_s=MULTIHOST_WALL_S)
        if not rec["ok"]:
            fail(f"multihost_run {mode}: {rec['errors']}")
        procs = [{k: v for k, v in p.items()
                  if k not in ("group_values", "group_mask", "tdigest")}
                 for p in rec["processes"]]
        out["multihost"][mode] = {"wall_s": time.perf_counter() - t0,
                                  "processes": procs}
        log(f"multihost_run {mode}: {json.dumps(procs)}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def http_union_any(port: int, expr: str, start: int,
                   end: int) -> tuple[list, dict, bytes]:
    """One /q run on the scan path (every group "rollup": "raw"), with
    or without a downsampler."""
    target = "/q?" + urllib.parse.urlencode(
        {"start": start, "end": end, "m": expr, "json": ""})
    q0 = time.perf_counter()
    status, body = http_get(port, target)
    wall = (time.perf_counter() - q0) * 1e3
    if status != 200:
        fail(f"{expr}: HTTP {status}: {body[:300]!r}")
    answer = json.loads(body)
    if not answer or any(g["rollup"] != "raw" for g in answer):
        fail(f"{expr}: not answered by the scan path: "
             f"{[g.get('rollup') for g in answer]}")
    return answer, {"wall_ms": wall}, body



def _catch(fn, errs: list) -> None:
    try:
        fn()
    except BaseException as e:  # re-raised by the caller
        errs.append(e)


def main() -> int:
    global SHARE_DIR
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
    folds, fold_counts = rollup_fold_cases()
    smooth, forecast_counts = smoothing_kernel_cases(ts, vals, next(
        r["ms_device"] for r in kernels if r["name"] == "launch_floor"))
    kernels += folds + smooth + mesh_kernel_phase() + expert_kernel_phase()
    # The kernel-count children run beside the path phase, after every
    # timed case.
    jobs = [start_fold_count(fold_counts),
            start_forecast_count(forecast_counts)]
    try:
        with tempfile.TemporaryDirectory() as share:
            SHARE_DIR = share
            children = {p: start_child(p) for p in CHILD_PHASES}
            try:
                with tempfile.TemporaryDirectory() as wal_dir:
                    path = path_phase(ts, vals, wal_dir)
                log("path phase done; joining the sharded, rollup, mesh "
                    "and fleet phases")
                done = {p: join_child(p, proc)
                        for p, proc in children.items()}
            finally:
                stop_children(children)
            SHARE_DIR = ""
        join_fold_count(jobs[0], folds)
        join_forecast_count(jobs[1], smooth)
    finally:
        for proc, d, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            shutil.rmtree(d, ignore_errors=True)
    sharded, rollup, mesh = done["sharded"], done["rollup"], done["mesh"]
    fleet = done["fleet"]
    log("compressed phase")
    compressed = compressed_phase(ts, vals, path)
    kernels += compressed["kernel_cases"]
    REFERENCE.clear()
    cli = cli_phase(ts, vals)
    del ts, vals
    refusal = refusal_phase()
    budget = budget_phase()

    # Each path's launches beside the times at that path's shape; the
    # first path listed gives a kernel's top-level numbers. The replica
    # path's times are those of its own largest call of each kernel.
    replica = path["restart"]["replica"]
    router = path["restart"]["router"]
    kernels += replica["kernel_cases"] + router["kernel_cases"]
    at_replica = {r["name"]: r["stage"] for r in replica["kernel_cases"]}
    at_router = {r["name"]: r["stage"] for r in router["kernel_cases"]}
    fold = {"resident": "window chunk fold", "scan": "series stage"}
    shapes = {
        "segment_sum": fold, "segment_minmax": fold,
        "masked_select": {"resident": "window select, columns",
                          "union": "union p95 {dc=dc0} one day"},
        "interp_moments": {"union": "union {dc=dc0} one day"},
        "tdigest_fold": {"sketch":
                         "one hand-off (1,049 series x 1,000 values)"},
        "hll_fold": {"sketch": "one hand-off: host + dc, p = 12"},
        "hll_estimate": {"sketch": "over the p = 12 stack (8 x 4096)"},
        "merged_quantile": {"sketch":
                            "all series, S = 16,384 (2,097,152 entries)"},
        "block_decode": {"fused": "week gather (TSF32)"},
        "rollup_fold": {"device fold": ROLLUP_GROUP_STAGE},
        "ewma_scan": {"forecast": "{host=*} 1h"},
        "holt_winters": {"forecast": "{host=*} 1h, season 24"},
        "moment_combine": {"mesh": "{host=*} week"},
        "tile_carries": {"mesh": "{host=h00001} week"},
        "dash_finish": {"expert": next(iter(dash_cases()))},
        "hybrid_moment_combine": {"hybrid": hybrid_stages()["finish"]}}
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
                         "opentsdb_tpu/compress/kernels.py:72"),
        "rollup_fold": ROLLUP_FOLD_WHERE, **SMOOTHING_WHERE,
        **MESH_WHERE, **EXPERT_WHERE}
    for name, stage in at_replica.items():
        shapes[name] = dict(shapes[name], replica=stage)
    for name, stage in at_router.items():
        shapes[name] = dict(shapes[name], router=stage)
    numbers = ("max_abs_err", "ms", "ms_cold", "ms_device", "plain_ms",
               "bound_ms", "bound_by", "library_ms")
    by_case = {(r["name"], r["stage"]): r for r in kernels}
    path_launches_of = dict(
        path["launches"], fused=compressed["launches"],
        forecast=path["forecast"]["launches"],
        replica=replica["launches"], router=router["launches"],
        mesh=mesh["launches"]["mesh"], expert=mesh["launches"]["expert"],
        hybrid=fleet["launches"],
        **{"device fold": {
            "rollup_fold": rollup["device_fold"]["launches"]}})
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
                  and not r["stage"].startswith(("replica ", "router "))
                  and name in SKETCH_KERNELS + ("block_decode",
                                                "rollup_fold")
                  + tuple(SMOOTHING_WHERE) + MESH_KERNELS
                  + EXPERT_KERNELS]
        if others:
            floors = (("chain_floor_ms", "launch_floor_ms", "binds", "share")
                      if name in SMOOTHING_WHERE else ())
            entry["other_cases"] = {
                r["stage"]: {k: r[k] for k in numbers + floors if k in r}
                for r in others}
        if name in MESH_KERNELS + EXPERT_KERNELS:
            entry["library"] = NO_LIBRARY
        if name in ("block_decode", "rollup_fold") + tuple(
                SMOOTHING_WHERE):
            entry["library"] = NO_LIBRARY
            entry["kernels_per_call"] = by_case[(
                name, next(iter(shape.values())))]["kernels_per_call"]
        if name in SMOOTHING_WHERE:
            r = by_case[(name, next(iter(shape.values())))]
            entry.update({k: r[k] for k in (
                "bytes_bound_ms", "chain_floor_ms", "launch_floor_ms",
                "binds", "share")})
        line.append(entry)
    log(json.dumps({"details": {
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "kernel_cases": kernels, "path": path,
        "compressed": compressed, "rollup": rollup, "sharded": sharded,
        "mesh": mesh, "fleet": fleet, "refusal": refusal, "cli": cli,
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
    fm = compressed["fused_mesh"]
    print(json.dumps({"fused_mesh": {
        **FUSED_MESH_WHERE,
        **{k: fm[k] for k in ("D", "launches", "dispatches",
                              "moment_combine_checks", "indivisible",
                              "phase_s")},
        "queries": fm["queries"],
        "body": {k: fm["body"][k] for k in (
            "stage", "points", "shard_points", "padded_points",
            "launches_per_call", "ms", "ms_device", "plain_ms", "bound_ms",
            "bound_by", "share", "max_abs_err", "library")},
        "concurrency": f"not claimed: {FUSED_MESH_D} logical shards of "
                       f"one card run one after another"}, "card": smi}))
    print(json.dumps({"cli": cli, "card": smi}))
    ro = rollup
    print(json.dumps({"rollup": {
        "series": ro["series"], "of_series": ro["of_series"],
        "ingest": ro["ingest"], "checkpoint_1": ro["checkpoint_1"],
        "checkpoint_2": ro["checkpoint_2"], "queries": ro["queries"],
        "launches": ro["launches"], "declines": ro["declines"],
        "backfill": ro["backfill"],
        "ranged": {k: {"ms": v["ms"], "header": v["header"]}
                   for k, v in ro["ranged"].items()},
        "boot_s": ro["boot_s"], "after_restart": ro["after_restart"],
        "crash_reopen_s": ro["crash_reopen_s"],
        "after_crash": ro["after_crash"], "api_queries": ro["api_queries"],
        "device_fold": dict(ro["device_fold"], profiled=next(
            r["profiled_tier_calls"] for r in kernels
            if "profiled_tier_calls" in r)),
        "fold_cases": {r["stage"]: {k: r[k] for k in (
            "points", "series", "windows", "ms", "ms_cold", "ms_device",
            "plain_ms", "scatter_composite_ms", "entry_ms",
            "one_series_entry_ms", "host_fold_ms", "bound_ms", "bytes",
            "max_abs_err", "kernels_per_call", "profiled")
            if k in r}
            for r in kernels if r["name"] == "rollup_fold"}},
        "card": smi}))
    print(json.dumps({"forecast": {
        "runs": path["forecast"]["runs"],
        "launches": path["forecast"]["launches"],
        "kernels": {f"{r['name']} [{r['stage']}]": {k: r[k] for k in (
            "series", "steps", "ms", "ms_cold", "ms_device", "plain_ms",
            "bound_ms", "bound_by", "bytes_bound_ms", "chain_floor_ms",
            "launch_floor_ms", "binds", "share", "kernels_per_call",
            "profiled")}
            for r in kernels if r["name"] in SMOOTHING_WHERE}},
        "approx": rollup["approx"], "card": smi}))
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
    print(json.dumps({"replica": {
        **{k: replica[k] for k in (
            "boot_s", "boot_split_s", "queries", "sketch_at_boot",
            "healthz_before", "healthz_after", "tail_lag_ms", "tail_polls",
            "writer_checkpoint_s", "rebuild_ms", "reload_ms",
            "sketch_after_checkpoint", "reloads",
            "reload_suffix_points", "reload_memory_delta_bytes",
            "writer_stop_s", "promotion_s", "promotion_split_s",
            "promoted", "launches", "replica_launches", "phase_s")},
        "kernel_checks": {name: {
            "calls": sum(c["name"] == name for c in replica["kernel_checks"]),
            "max_abs_err": max(c["max_abs_err"] for c in
                               replica["kernel_checks"] if c["name"] == name)}
            for name in REPLICA_KERNELS},
        "sharded": sharded["replica"], "rollup": rollup["replica"]},
        "card": smi}))
    print(json.dumps({"router": {
        **{k: router[k] for k in (
            "replica_boot_s", "router_boot_s", "router_imports", "queries",
            "hop", "retry", "hedge", "put", "launches", "router_exit",
            "phase_s")},
        "kernel_checks": {name: {
            "calls": sum(c["name"] == name for c in router["kernel_checks"]),
            "max_abs_err": max(c["max_abs_err"] for c in
                               router["kernel_checks"] if c["name"] == name)}
            for name in sorted({c["name"] for c in
                                router["kernel_checks"]})},
        "failover": rollup["router"]}, "card": smi}))
    print(json.dumps({"mesh": {
        **{k: mesh[k] for k in (
            "shards", "ingest", "resident", "after_reshard", "reshard",
            "flow", "scan", "launches", "compile_cache", "healthz_mesh",
            "phase_s")},
        "kernel_checks": {name: {
            "calls": sum(c["name"] == name for c in mesh["kernel_checks"]),
            "bit_equal": all(c["bit_equal"] for c in mesh["kernel_checks"]
                             if c["name"] == name),
            "shapes": sorted({(c["arg"], c["D"], c["size"])
                              for c in mesh["kernel_checks"]
                              if c["name"] == name})}
            for name in MESH_KERNELS},
        "interconnect": f"not measured: {MESH_D} logical shards of one "
                        f"card"},
        "card": smi}))
    ex = mesh["expert"]
    print(json.dumps({"expert": {
        **{k: ex[k] for k in (
            "panels", "fold", "grid", "slots", "corpus_points_per_slot",
            "expert_ms", "scan_ms", "resident_ms", "against_scan",
            "resident_against_scan", "decline")},
        "launches": mesh["launches"]["expert"],
        "kernel_checks": {
            "calls": len(ex["kernel_checks"]),
            "held": "fills, masks, counts, min and max bit for bit, sums "
                    "within rtol 1e-5 + 1e-5 x scale",
            "max_abs_err": max(c["max_abs_err"]
                               for c in ex["kernel_checks"]),
            "shapes": sorted({(c["slots"], c["S"], c["B"],
                               c["agg_codes"] is None)
                              for c in ex["kernel_checks"]})},
        "concurrency": f"not claimed: {MESH_D} logical shards of one card "
                       f"run one after another"},
        "card": smi}))
    print(json.dumps({"fleet": {
        **{k: fleet[k] for k in (
            "fold", "points", "series_per_shard", "launches", "group",
            "hll", "tdigest", "mixed_batch", "multihost", "phase_s")},
        "kernel_checks": fleet["kernel_checks"],
        "transport": "gloo (two processes on one card; NCCL needs a card "
                     "a rank: not measured)"},
        "card": smi}))
    print(json.dumps({"window_at_budget": {
        k: budget[k] for k in ("points", "chunks", "resident_bytes",
                               "fill_points_per_s", "queries",
                               "eviction")}, "card": smi}))
    print(json.dumps({"launch_floor": next(
        r for r in kernels if r["name"] == "launch_floor"), "card": smi}))
    log(json.dumps({"earlier": {
        "note": "typed in from PERF.md (earlier PRs' chip runs, H100 80GB "
                "HBM3, 700 W), not measured by this run",
        "cases": [{"name": name, "stage": stage, **then,
                   "this_run": {k: by_case[(name, stage)][k] for k in (
                       "ms", "ms_cold", "ms_device")}}
                  for (name, stage), then in EARLIER_MS.items()]}}))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child_main(sys.argv[2], sys.argv[3], float(sys.argv[4]),
                            int(sys.argv[5])))
    sys.exit(main())
