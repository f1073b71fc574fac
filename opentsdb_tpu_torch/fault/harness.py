"""Crash-consistency harness: scripted workload, child crash, verify.

Mirrors ``opentsdb_tpu/fault/harness.py`` of the JAX package, trimmed to
the port's tiers. One scenario:

1. spawn a child process (``python -m opentsdb_tpu_torch.fault.harness
   --child``) that runs a seeded, deterministic ingest / backfill / delete
   / checkpoint workload against a real store (the float64 host backend,
   window and sketches off, as the JAX child runs; on the card unless
   ``--device cpu`` asks for the CPU), with one failpoint armed through
   ``TSDB_FAULTPOINTS`` (``fault/faultpoints.py``);
2. the armed site kills the child (``os._exit``: the flock drops, the
   page cache survives, as under SIGKILL);
3. the parent reopens the store and checks the crash-consistency
   invariants:
     - recovery succeeds and **fsck is clean** (``tools/fsck.run_fsck``,
       the operator tool itself);
     - **raw golden parity**: every stored point matches an in-memory
       oracle replayed over the acknowledged ops (the progress file names
       them; the one op possibly in flight is probed: each op is one WAL
       record, present or absent as a whole);
     - **tenant accounting**: every stored series is known to the
       accountant, and its counts are exact (or, on the HLL tier, within
       the declared error).

Scenarios are deterministic given (seed, site, mode, skip): the sharded
store spills serially while a fault is armed, the workload is a pure
function of its seed, and torn offsets derive from the arming's seed. A
failing scenario is shrunk (geometrically fewer ops, same seed) to a
smaller failing repro, and ``repro_command`` prints a command line that
reruns it alone.

``build_matrix()`` is the sweep over the sites the port has, at 1 and 4
shards; ``FAST_LABELS`` names the tier-1 subset. ``--bug
ack-before-fsync`` re-introduces, in the child, the group-commit bug the
matrix must catch (acknowledging before the covering flush).

A scenario's ``codec`` ("tsst4") makes the workload spill compressed
TSST4 generations; the verifier reopens with the same codec, so its
checkpoints and fsck's block audit run the v4 writers and readers again.
The ``sst-block-*`` rows cut or kill inside a compressed block
(``sst.write.block``).

Left out (ROADMAP queue A): the rollup rows and the rollup query parity
(item 6), the replica and promote kinds and the replica refresh check
(item 10), and ``meshreshard`` (item 11).

Run the port's matrix (or one scenario); ``--device cpu`` on a host
without a card::

    python -m opentsdb_tpu_torch.fault.harness --fast --device cpu
    python -m opentsdb_tpu_torch.fault.harness --only ckpt-freeze-crash-s4
    python -m opentsdb_tpu_torch.fault.harness --site kv.wal.append \\
        --mode torn --skip 2 --shards 1 --seed 1001 --n-ops 36
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
import shutil
import subprocess
import sys

import numpy as np

from opentsdb_tpu_torch.core import codec
from opentsdb_tpu_torch.core.errors import NoSuchUniqueName
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.fault import faultpoints
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config

# Day-aligned workload epoch; forward hours allocate upward from here,
# backfill hours downward, so re-ingest never creates conflicting
# duplicates.
T0 = 1_600_000_000 - 1_600_000_000 % 86400

_SERIES = [
    ("sys.cpu.user", {"host": "web1", "dc": "east"}),
    ("sys.cpu.user", {"host": "web2", "dc": "east"}),
    ("sys.cpu.user", {"host": "db1", "dc": "west"}),
    ("net.bytes", {"host": "web1"}),
]

CHILD_TIMEOUT = 120.0

BUGS = ("ack-before-fsync",)


@dataclasses.dataclass
class Scenario:
    label: str
    site: str
    mode: str
    skip: int = 0
    count: int = 1
    shards: int = 1
    seed: int = 1234
    n_ops: int = 36
    delete_heavy: bool = False
    bug: str | None = None
    # Tenant accounting tier (-1 = the Config default exact cutoff): 0
    # puts every tenant on the HLL tier, so the snapshot rows also cover
    # the estimate-within-error recovery contract.
    tenant_cutoff: int = -1
    # WAL group commit (Config.wal_group_ms) for the workload: > 0 routes
    # every append through the group flush, so the kv.wal.group.* sites
    # are reachable and acknowledged ops must be covered by a group flush
    # before the progress file sees them.
    wal_group_ms: float = 0.0
    # Write-side sstable codec of the workload ("none" | "tsst4").
    codec: str = "none"
    # Config.device of the child's and the verifier's TSDB.
    device: str = "cuda"


# ---------------------------------------------------------------------------
# Workload: the deterministic op schedule and the in-memory oracle
# ---------------------------------------------------------------------------

def gen_ops(seed: int, n_ops: int,
            delete_heavy: bool = False) -> list[tuple]:
    """The scripted op sequence of a scenario, a pure function of its
    arguments (the JAX harness's, op for op): the child runs it, the
    parent replays it into the oracle. Ops: ("ingest", si, hour, n_hours,
    step, is_float, vbase), ("delete_row"|"delete_cells", si, hour),
    ("checkpoint",)."""
    rng = random.Random(seed)
    fwd = [0] * len(_SERIES)
    bwd = [1] * len(_SERIES)
    ops: list[tuple] = []
    live: list[tuple[int, int]] = []   # deletable (si, hour) pairs

    def ingest(si: int, backfill: bool) -> None:
        n_hours = rng.randint(1, 2)
        if backfill:
            hour = T0 - (bwd[si] + n_hours - 1) * 3600
            bwd[si] += n_hours
        else:
            hour = T0 + fwd[si] * 3600
            fwd[si] += n_hours
        step = rng.choice((300, 600, 900))
        is_float = 1 if rng.random() < 0.3 else 0
        ops.append(("ingest", si, hour, n_hours, step, is_float,
                    rng.randrange(1, 1000)))
        for h in range(n_hours):
            live.append((si, hour + h * 3600))

    del_band = 0.85 if delete_heavy else 0.72
    for i in range(n_ops):
        r = rng.random()
        if i < 4 or r < 0.45:
            ingest(rng.randrange(len(_SERIES)), backfill=False)
        elif r < 0.60:
            ingest(rng.randrange(len(_SERIES)), backfill=True)
        elif r < del_band and live:
            si, hour = live.pop(rng.randrange(len(live)))
            ops.append(("delete_row" if rng.random() < 0.5
                        else "delete_cells", si, hour))
        else:
            ops.append(("checkpoint",))
    # A deterministic tail: at least two checkpoints (every spill site is
    # reachable), ending with live memtable state (every reopen replays).
    ops.append(("checkpoint",))
    ingest(0, backfill=False)
    ops.append(("checkpoint",))
    ingest(1, backfill=False)
    return ops


def points_for(op: tuple):
    """(ts int64, values f64, int_values i64, is_float bool) of one ingest
    op, derived from the op tuple alone, so the child's add_batch and the
    parent's oracle cannot disagree. Float values are float32-exact
    (quarters); ints stay on the exact int path."""
    _, _si, hour, n_hours, step, is_float, vbase = op
    per = 3600 // step
    ts = np.concatenate([
        hour + h * 3600 + np.arange(per, dtype=np.int64) * step
        for h in range(n_hours)])
    idx = np.arange(len(ts))
    if is_float:
        f = (vbase % 97) + (idx % 40) * 0.25
        return (ts, f.astype(np.float64),
                np.zeros(len(ts), np.int64), np.ones(len(ts), bool))
    iv = (vbase + idx % 997).astype(np.int64)
    return ts, iv.astype(np.float64), iv, np.zeros(len(ts), bool)


class Oracle:
    """The ground truth: {series index: {ts: (is_float, value)}}."""

    def __init__(self) -> None:
        self.data: dict[int, dict[int, tuple[bool, float]]] = {
            si: {} for si in range(len(_SERIES))}

    def apply(self, op: tuple) -> None:
        kind = op[0]
        if kind == "ingest":
            ts, f64, iv, fl = points_for(op)
            d = self.data[op[1]]
            for t, fv, i, isf in zip(ts.tolist(), f64.tolist(),
                                     iv.tolist(), fl.tolist()):
                d[t] = (bool(isf), fv if isf else i)
        elif kind in ("delete_row", "delete_cells"):
            _, si, hour = op
            d = self.data[si]
            for t in [t for t in d if hour <= t < hour + 3600]:
                del d[t]

    def state_hash(self) -> str:
        h = hashlib.sha1()
        for si in sorted(self.data):
            for t in sorted(self.data[si]):
                isf, v = self.data[si][t]
                h.update(f"{si}:{t}:{int(isf)}:{v!r};".encode())
        return h.hexdigest()


# ---------------------------------------------------------------------------
# Store plumbing shared by the child and the parent
# ---------------------------------------------------------------------------

def open_store(dirpath: str, shards: int):
    """The scenario's store, at the JAX harness's paths: a sharded store
    at ``dirpath`` itself, one store's WAL at ``dirpath/wal``."""
    if shards > 1:
        from opentsdb_tpu_torch.storage.sharded import ShardedKVStore
        return ShardedKVStore(dirpath, shards=shards)
    return MemKVStore(wal_path=os.path.join(dirpath, "wal"))


def open_tsdb(dirpath: str, shards: int, tenant_cutoff: int = -1,
              wal_group_ms: float = 0.0, device: str = "cuda",
              codec: str = "none") -> TSDB:
    """The writer TSDB with the harness's profile: the float64 host
    backend, sketches and the device window off, compactions off and no
    background thread (a deterministic schedule). Tenant accounting stays
    on (its default): every crash scenario is also a recovery check of
    the tenant snapshot."""
    cfg = Config(device=device, backend="cpu", auto_create_metrics=True,
                 enable_compactions=False, enable_sketches=False,
                 device_window=False, wal_group_ms=wal_group_ms,
                 sstable_codec=codec)
    if tenant_cutoff >= 0:
        cfg.tenant_exact_cutoff = tenant_cutoff
    return TSDB(open_store(dirpath, shards), cfg,
                start_compaction_thread=False)


def _row_key(tsdb: TSDB, si: int, hour: int) -> bytes:
    metric, tags = _SERIES[si]
    return tsdb.row_key_for(metric, tags, hour, create_metric=False,
                            create_tags=False)


def apply_op(tsdb: TSDB, op: tuple) -> None:
    kind = op[0]
    if kind == "ingest":
        ts, f64, iv, fl = points_for(op)
        metric, tags = _SERIES[op[1]]
        tsdb.add_batch(metric, ts, f64, tags, is_float=fl,
                       int_values=iv)
    elif kind == "delete_row":
        tsdb.store.delete_row(tsdb.table, _row_key(tsdb, op[1], op[2]))
    elif kind == "delete_cells":
        key = _row_key(tsdb, op[1], op[2])
        cells = tsdb.store.get(tsdb.table, key, b"t")
        if cells:
            tsdb.store.delete(tsdb.table, key, b"t",
                              [c.qualifier for c in cells])
    elif kind == "checkpoint":
        tsdb.checkpoint()
    else:  # pragma: no cover - schedule bug
        raise ValueError(f"unknown op {op!r}")


def _op_applied(tsdb: TSDB, op: tuple) -> bool:
    """Did the op the crash interrupted reach durable storage? Each op is
    one series and one WAL record in one shard, so after recovery it is
    present or absent as a whole: one row probe decides."""
    kind = op[0]
    if kind == "checkpoint":
        return False  # nothing the oracle sees
    try:
        key = _row_key(tsdb, op[1], op[2])
    except NoSuchUniqueName:
        # UIDs are created before the data put: missing UIDs mean the
        # op's data cannot be in storage either.
        return kind != "ingest"  # a delete's target simply vanished
    if kind == "ingest":
        return tsdb.store.has_row(tsdb.table, key)
    return tsdb.store.cell_count(tsdb.table, key) == 0


def _apply_bug(bug: str) -> None:
    """Re-introduce a durability bug in the child, so tests can show the
    matrix catches it. ``ack-before-fsync``: the WAL barrier returns
    before the covering group flush, so acknowledged appends (which the
    progress file records) sit in the userspace buffer, and a crash at
    ``kv.wal.group.write`` loses them; verify must flag the rows."""
    if bug == "ack-before-fsync":
        MemKVStore._ACK_BEFORE_FSYNC = True
    else:
        raise ValueError(f"unknown --bug {bug!r} (one of {BUGS})")


# ---------------------------------------------------------------------------
# The child
# ---------------------------------------------------------------------------

def _child_main(args) -> int:
    ops = gen_ops(args.seed, args.n_ops, args.delete_heavy)
    if args.bug:
        _apply_bug(args.bug)
    tsdb = open_tsdb(args.dir, args.shards,
                     tenant_cutoff=args.tenant_cutoff,
                     wal_group_ms=args.wal_group_ms, device=args.device,
                     codec=args.codec)
    with open(args.progress, "a") as pf:
        for i, op in enumerate(ops):
            apply_op(tsdb, op)
            # Flushed (the page cache survives os._exit): every op the
            # parent sees here was acknowledged, so its WAL record was
            # flushed first and recovery must surface it.
            pf.write(f"{i}\n")
            pf.flush()
        pf.write("end\n")
        pf.flush()
    tsdb.shutdown()
    return 0


def _read_progress(path: str) -> tuple[int, bool]:
    """(ops completed, reached the end of the schedule)."""
    try:
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
    except OSError:
        return 0, False
    done = 0
    finished = False
    for ln in lines:
        if ln == "end":
            finished = True
        else:
            done = max(done, int(ln) + 1)
    return done, finished


# ---------------------------------------------------------------------------
# The parent: verification
# ---------------------------------------------------------------------------

def _check_raw_parity(tsdb: TSDB, oracle: Oracle) -> list[str]:
    problems: list[str] = []
    try:
        _, per_series = tsdb.scan_series(b"", b"\xff" * 64)
    except Exception as e:
        return [f"raw scan failed: {e!r}"]
    expected: dict[bytes, dict[int, tuple[bool, float]]] = {}
    for si, pts in oracle.data.items():
        if not pts:
            continue
        try:
            key = _row_key(tsdb, si, 0)
        except NoSuchUniqueName:
            problems.append(f"series {si}: oracle has points but UIDs "
                            f"are missing")
            continue
        expected[codec.series_key(key)] = pts
    for skey, pts in expected.items():
        cols = per_series.pop(skey, None)
        if cols is None:
            problems.append(f"series {skey.hex()}: {len(pts)} oracle "
                            f"points missing from storage")
            continue
        ts_e = np.fromiter(sorted(pts), np.int64, len(pts))
        if not np.array_equal(cols.timestamps, ts_e):
            problems.append(
                f"series {skey.hex()}: timestamp mismatch "
                f"(engine {len(cols.timestamps)} vs oracle {len(ts_e)})")
            continue
        isf_e = np.array([pts[t][0] for t in ts_e.tolist()], bool)
        if not np.array_equal(cols.is_float.astype(bool), isf_e):
            problems.append(f"series {skey.hex()}: float-flag mismatch")
            continue
        vals_e = np.array([pts[t][1] for t in ts_e.tolist()],
                          np.float64)
        # Floats round-trip through the stored float32; ints are exact.
        fbad = isf_e & (cols.values !=
                        vals_e.astype(np.float32).astype(np.float64))
        ibad = ~isf_e & (cols.int_values != vals_e.astype(np.int64))
        if fbad.any() or ibad.any():
            problems.append(f"series {skey.hex()}: value mismatch at "
                            f"ts={int(ts_e[(fbad | ibad)][0])}")
    for skey, cols in per_series.items():
        if len(cols.timestamps):
            problems.append(f"series {skey.hex()}: {len(cols.timestamps)}"
                            f" stored points the oracle never wrote")
    return problems


def _check_tenant_accounting(tsdb: TSDB) -> list[str]:
    """The tenant snapshot's recovery oracle, on the freshly reopened
    store: every stored series is in the accountant's seen set; the
    tracked total equals the exact per-tenant counts (the workload is one
    tenant), and after a rebuild (a torn or foreign snapshot) equals the
    stored series count; on the HLL tier the estimate lies within 3x the
    declared relative error (at least 2 absolute)."""
    from opentsdb_tpu_torch.storage.sstable import series_hash
    from opentsdb_tpu_torch.tenant.accounting import hll_rel_error
    acct = tsdb.tenants
    if acct is None:
        return ["tenant accounting unexpectedly disabled after reopen"]
    problems: list[str] = []
    stored: set[int] = set()
    for key, _items in tsdb.store.scan_raw(tsdb.table, b"",
                                           b"\xff" * 64):
        stored.add(series_hash(codec.series_key(key)))
    missing = sum(1 for h in stored if not acct.seen(h))
    if missing:
        problems.append(f"tenant accounting is missing {missing} of "
                        f"{len(stored)} stored series")
    if acct.rebuilt and acct.total_tracked() != len(stored):
        problems.append(
            f"rebuilt tenant accounting tracks "
            f"{acct.total_tracked()} series, storage holds "
            f"{len(stored)} (rebuild must be exact)")
    info = acct.snapshot_info()
    true = acct.total_tracked()
    est = sum(ent["series"] for ent in info["tenants"].values())
    tiers = {ent["tier"] for ent in info["tenants"].values()}
    if tiers == {"exact"}:
        if est != true:
            problems.append(f"exact-tier tenant counts sum to {est}, "
                            f"seen-set holds {true}")
    elif true:
        bound = max(3 * hll_rel_error(acct.hll_p) * true, 2)
        if abs(est - true) > bound:
            problems.append(
                f"sketch-tier tenant estimate {est} outside "
                f"±{bound:.1f} of true {true}")
    return problems


def verify(dirpath: str, sc: Scenario, ops: list[tuple],
           ops_done: int) -> tuple[list[str], str]:
    """Reopen after the crash and check every invariant. Returns
    (problems, the oracle's state hash)."""
    from opentsdb_tpu_torch.tools.fsck import run_fsck
    problems: list[str] = []
    try:
        tsdb = open_tsdb(dirpath, sc.shards,
                         tenant_cutoff=sc.tenant_cutoff,
                         wal_group_ms=sc.wal_group_ms, device=sc.device,
                         codec=sc.codec)
    except Exception as e:
        return [f"reopen failed: {e!r}"], ""
    try:
        # Instrumentation canary: the recovery fsck must land an
        # fsck.duration sample in the metrics registry, so instruments
        # that break on a recovery path fail the matrix.
        from opentsdb_tpu_torch.obs.registry import METRICS
        fsck_timer = METRICS.timer("fsck.duration")
        fsck_count0 = fsck_timer.count
        rep = run_fsck(tsdb, log=problems.append)
        if fsck_timer.count <= fsck_count0:
            problems.append(
                "fsck ran but recorded no fsck.duration timer sample "
                "(metrics registry broken on the recovery path)")
        if rep.errors:
            problems.append(f"fsck: {rep.errors} errors")
        oracle = Oracle()
        for op in ops[:ops_done]:
            oracle.apply(op)
        if ops_done < len(ops) and _op_applied(tsdb, ops[ops_done]):
            # The op the crash interrupted: one WAL record, so one probe
            # decides its fate.
            oracle.apply(ops[ops_done])
        problems += _check_raw_parity(tsdb, oracle)
        problems += _check_tenant_accounting(tsdb)
        return problems, oracle.state_hash()
    except Exception as e:  # the verification itself broke
        import traceback
        return (problems + [f"verify crashed: {e!r}",
                            traceback.format_exc(limit=5)], "")
    finally:
        try:
            tsdb.shutdown()
        except Exception as e:
            problems.append(f"shutdown after verify failed: {e!r}")


# ---------------------------------------------------------------------------
# The parent: running a scenario
# ---------------------------------------------------------------------------

def _repo_root() -> str:
    import opentsdb_tpu_torch
    return os.path.dirname(os.path.dirname(
        os.path.abspath(opentsdb_tpu_torch.__file__)))


def child_command(sc: Scenario, store_dir: str, progress: str) -> list[str]:
    """The child's command line (``python -m
    opentsdb_tpu_torch.fault.harness --child ...``)."""
    cmd = [sys.executable, "-m", "opentsdb_tpu_torch.fault.harness",
           "--child", "--dir", store_dir, "--seed", str(sc.seed),
           "--n-ops", str(sc.n_ops), "--shards", str(sc.shards),
           "--device", sc.device, "--progress", progress]
    if sc.delete_heavy:
        cmd.append("--delete-heavy")
    if sc.bug:
        cmd += ["--bug", sc.bug]
    if sc.tenant_cutoff >= 0:
        cmd += ["--tenant-cutoff", str(sc.tenant_cutoff)]
    if sc.wal_group_ms > 0:
        cmd += ["--wal-group-ms", str(sc.wal_group_ms)]
    if sc.codec != "none":
        cmd += ["--codec", sc.codec]
    return cmd


def _run_once(sc: Scenario, workdir: str) -> dict:
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir, exist_ok=True)
    store_dir = os.path.join(workdir, "store")
    progress = os.path.join(workdir, "progress")
    env = dict(os.environ)
    env[faultpoints.ENV_VAR] = faultpoints.format_spec(
        sc.site, sc.mode, skip=sc.skip, count=sc.count, seed=sc.seed)
    env["PYTHONPATH"] = _repo_root() + os.pathsep + \
        env.get("PYTHONPATH", "")
    result = {
        "label": sc.label, "site": sc.site, "mode": sc.mode,
        "skip": sc.skip, "shards": sc.shards, "seed": sc.seed,
        "n_ops": sc.n_ops, "bug": sc.bug, "problems": [], "ops_done": 0,
    }
    try:
        proc = subprocess.run(child_command(sc, store_dir, progress),
                              env=env, capture_output=True,
                              timeout=CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        result.update(status="child-error", child_exit=None,
                      problems=["child timed out"])
        return result
    ops_done, finished = _read_progress(progress)
    result["child_exit"] = proc.returncode
    result["ops_done"] = ops_done
    state_hash = ""
    if proc.returncode == 0 and finished:
        # The armed site never fired: a scenario whose workload cannot
        # reach its failpoint would misreport coverage.
        result["status"] = "not-hit"
    elif proc.returncode != faultpoints.EXIT_CODE:
        result.update(status="child-error", problems=[
            f"child exit {proc.returncode}",
            proc.stderr.decode(errors="replace")[-2000:]])
    else:
        ops = gen_ops(sc.seed, sc.n_ops, sc.delete_heavy)
        problems, state_hash = verify(store_dir, sc, ops, ops_done)
        result["problems"] = problems
        result["status"] = "ok" if not problems else "invariant-failed"
    result["fingerprint"] = hashlib.sha1(
        f"{result['status']}|{result['child_exit']}|{ops_done}|"
        f"{';'.join(result['problems'])}|{state_hash}".encode()
    ).hexdigest()
    result["repro"] = repro_command(sc)
    return result


def repro_command(sc: Scenario) -> str:
    """A command line that reruns this scenario from its explicit
    parameters (label-independent, so ad-hoc and bug-injected scenarios
    reproduce too)."""
    out = (f"python -m opentsdb_tpu_torch.fault.harness --site {sc.site} "
           f"--mode {sc.mode} --skip {sc.skip} --shards {sc.shards} "
           f"--seed {sc.seed} --n-ops {sc.n_ops} --device {sc.device}")
    if sc.delete_heavy:
        out += " --delete-heavy"
    if sc.bug:
        out += f" --bug {sc.bug}"
    if sc.tenant_cutoff >= 0:
        out += f" --tenant-cutoff {sc.tenant_cutoff}"
    if sc.wal_group_ms > 0:
        out += f" --wal-group-ms {sc.wal_group_ms}"
    if sc.codec != "none":
        out += f" --codec {sc.codec}"
    return out


def _shrink(sc: Scenario, workdir: str) -> dict | None:
    """A smaller failing repro: geometrically fewer ops, the same seed and
    site. Returns the smallest configuration still failing, or None when
    only the full schedule fails."""
    best = None
    n = sc.n_ops
    tried = sorted({max(4, n // 2), max(4, n // 4), 8, 6, 4},
                   reverse=True)
    for cand in tried:
        if cand >= n:
            continue
        r = _run_once(dataclasses.replace(sc, n_ops=cand),
                      os.path.join(workdir, f"shrink-{cand}"))
        if r["status"] == "invariant-failed":
            best = {"n_ops": cand, "seed": sc.seed,
                    "problems": r["problems"][:3]}
            n = cand
    return best


def run_scenario(sc: Scenario, work_root: str,
                 shrink: bool = True) -> dict:
    if sc.mode not in ("crash", "torn"):
        # A raise/ioerror/delay child either errors out or finishes, and
        # _run_once would misreport both: those modes are for in-process
        # arming, not for a crash scenario.
        raise ValueError(
            f"{sc.label}: child crash scenarios support modes "
            f"crash/torn, not {sc.mode!r} (arm a live process for "
            f"in-process modes)")
    workdir = os.path.join(work_root, sc.label)
    res = _run_once(sc, workdir)
    if res["status"] == "invariant-failed" and shrink:
        res["min_repro"] = _shrink(sc, workdir)
    return res


# ---------------------------------------------------------------------------
# The matrix
# ---------------------------------------------------------------------------

# The tier-1 subset: one scenario per durability machine the port has,
# spread over 1 and 4 shards.
FAST_LABELS = (
    "wal-append-torn-s1",
    "wal-group-fsync-torn-s4",
    "ckpt-freeze-crash-s4",
    "ckpt-commit-crash-s1",
    "sst-body-torn-s4",
    "sst-footer-torn-s1",
    "sst-block-torn-s1",
    "tenant-snap-commit-torn-s4",
    "shard-join-crash-k2",
)


def build_matrix() -> list[Scenario]:
    """The JAX matrix's rows whose sites the port has, at 1 and 4 shards,
    with their labels, skips and seeds (``rollups=False``: the port has no
    rollup tier)."""
    scens: list[Scenario] = []

    def add(label: str, site: str, mode: str, **kw) -> None:
        scens.append(Scenario(label=label, site=site, mode=mode, **kw))

    for shards in (1, 4):
        t = f"s{shards}"
        c = dict(shards=shards, seed=1000 + shards)
        add(f"wal-append-crash-{t}", "kv.wal.append", "crash",
            skip=2, **c)
        add(f"wal-append-torn-{t}", "kv.wal.append", "torn",
            skip=2, **c)
        add(f"wal-append-torn-late-{t}", "kv.wal.append", "torn",
            skip=11, **c)
        add(f"wal-fsync-crash-{t}", "kv.wal.fsync", "crash",
            skip=4, **c)
        # Group commit: a crash at the buffered write (none of the
        # group's ops were acknowledged: the barrier still held them),
        # and a crash or torn cut at the group flush (the cut lands in
        # the WAL's unflushed tail, never in bytes a barrier released).
        add(f"wal-group-write-crash-{t}", "kv.wal.group.write",
            "crash", skip=30, wal_group_ms=2.0,
            **{**c, "seed": 7000 + shards})
        add(f"wal-group-fsync-crash-{t}", "kv.wal.group.fsync",
            "crash", skip=25, wal_group_ms=2.0,
            **{**c, "seed": 7010 + shards})
        add(f"wal-group-fsync-torn-{t}", "kv.wal.group.fsync",
            "torn", skip=30, wal_group_ms=2.0,
            **{**c, "seed": 7020 + shards})
        add(f"wal-group-fsync-torn-late-{t}", "kv.wal.group.fsync",
            "torn", skip=45, wal_group_ms=2.0,
            **{**c, "seed": 7030 + shards})
        add(f"ckpt-freeze-crash-{t}", "kv.checkpoint.freeze", "crash",
            **c)
        add(f"ckpt-freeze-crash2-{t}", "kv.checkpoint.freeze", "crash",
            skip=2, **c)
        add(f"ckpt-commit-crash-{t}", "kv.checkpoint.commit", "crash",
            **c)
        add(f"ckpt-commit-crash2-{t}", "kv.checkpoint.commit", "crash",
            skip=2, **c)
        add(f"ckpt-manifest-crash-{t}", "kv.checkpoint.manifest",
            "crash", **c)
        add(f"sst-body-crash-{t}", "sst.write.body", "crash", **c)
        add(f"sst-body-torn-{t}", "sst.write.body", "torn", **c)
        # Torn inside the footer section (index, bloom, trailer).
        add(f"sst-footer-torn-{t}", "sst.write.footer", "torn", **c)
        # Inside a TSST4 compressed block (sst.write.block fires per
        # flushed block): the spill dies mid-compression, leaving a temp
        # file whose last block is cut, which recovery must treat as a
        # stray while replaying <wal>.old.
        add(f"sst-block-crash-{t}", "sst.write.block", "crash",
            codec="tsst4", **c)
        add(f"sst-block-torn-{t}", "sst.write.block", "torn",
            codec="tsst4", **c)
        add(f"sst-block-torn-late-{t}", "sst.write.block", "torn",
            skip=2, codec="tsst4", **c)
        add(f"sst-rename-crash-{t}", "sst.rename", "crash", **c)
        # The tenant snapshot: a torn temp file leaves the previous
        # snapshot governing; a torn committed file is the corruption the
        # rebuild from storage must absorb exactly.
        add(f"tenant-snap-write-torn-{t}", "tenant.snapshot.write",
            "torn", **{**c, "seed": 5000 + shards})
        add(f"tenant-snap-commit-torn-{t}", "tenant.snapshot.commit",
            "torn", **{**c, "seed": 5010 + shards})
        add(f"tenant-snap-commit-crash-{t}", "tenant.snapshot.commit",
            "crash", **{**c, "seed": 5020 + shards})
    # Partial cross-shard spills: a crash after exactly k of 4 shards.
    for k in (1, 2, 3):
        add(f"shard-join-crash-k{k}", "sharded.spill.shard", "crash",
            skip=k - 1, shards=4, seed=2000 + k)
    # The JAX matrix's rollup-less raw-store rows.
    add("wal-append-crash-norollup", "kv.wal.append", "crash", skip=3,
        shards=1, seed=3001)
    add("ckpt-commit-crash-norollup", "kv.checkpoint.commit", "crash",
        shards=1, seed=3002)
    add("sst-block-torn-norollup", "sst.write.block", "torn",
        shards=1, codec="tsst4", seed=3003)
    add("sst-block-torn-norollup-s4", "sst.write.block", "torn",
        shards=4, codec="tsst4", seed=3004)
    # The HLL tier of tenant accounting (every tenant on it at cutoff 0):
    # a torn committed snapshot recovers within the declared error.
    add("tenant-snap-commit-torn-hll", "tenant.snapshot.commit",
        "torn", shards=1, seed=5101, tenant_cutoff=0)
    return scens


def fast_matrix() -> list[Scenario]:
    by_label = {s.label: s for s in build_matrix()}
    return [by_label[lb] for lb in FAST_LABELS]


def run_matrix(scens, work_root: str, shrink: bool = True,
               log=None) -> list[dict]:
    results = []
    for sc in scens:
        r = run_scenario(sc, work_root, shrink=shrink)
        if log:
            log(f"{r['status']:17s} {sc.label} "
                f"(ops_done={r['ops_done']})")
        results.append(r)
    return results


# ---------------------------------------------------------------------------
# Module entry: the child, or a run of the matrix or of one scenario
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    import tempfile
    p = argparse.ArgumentParser(prog="opentsdb_tpu_torch.fault.harness")
    p.add_argument("--child", action="store_true",
                   help="run the workload (a scenario's child process)")
    p.add_argument("--dir")
    p.add_argument("--progress")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--n-ops", type=int, default=36)
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--delete-heavy", action="store_true")
    p.add_argument("--bug", default=None, choices=BUGS)
    p.add_argument("--tenant-cutoff", type=int, default=-1)
    p.add_argument("--wal-group-ms", type=float, default=0.0)
    p.add_argument("--codec", default="none", choices=("none", "tsst4"),
                   help="Config.sstable_codec of the workload")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="Config.device of the workload and the verifier "
                        "(cpu on a host without a card)")
    p.add_argument("--site", default=None,
                   help="run one ad-hoc scenario at this failpoint site")
    p.add_argument("--mode", default="crash", choices=("crash", "torn"))
    p.add_argument("--skip", type=int, default=0)
    p.add_argument("--fast", action="store_true",
                   help="run the tier-1 subset (FAST_LABELS)")
    p.add_argument("--only", action="append", default=[],
                   help="run the matrix rows whose label contains this "
                        "(repeatable)")
    p.add_argument("--json", default=None,
                   help="write the per-scenario results here")
    p.add_argument("--work-dir", default=None)
    args = p.parse_args(argv)
    if args.child:
        return _child_main(args)
    if args.site:
        scens = [Scenario(
            label="adhoc", site=args.site, mode=args.mode, skip=args.skip,
            shards=args.shards, seed=args.seed, n_ops=args.n_ops,
            delete_heavy=args.delete_heavy, bug=args.bug,
            tenant_cutoff=args.tenant_cutoff,
            wal_group_ms=args.wal_group_ms, codec=args.codec)]
    elif args.fast:
        scens = fast_matrix()
    else:
        scens = [s for s in build_matrix()
                 if not args.only or any(o in s.label for o in args.only)]
    scens = [dataclasses.replace(s, device=args.device) for s in scens]
    work = args.work_dir or tempfile.mkdtemp(prefix="crashmatrix-")
    results = run_matrix(scens, work, log=print)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"scenarios": len(results),
                       "passed": sum(r["status"] == "ok" for r in results),
                       "results": results}, f, indent=1)
    if not args.work_dir:
        shutil.rmtree(work, ignore_errors=True)
    return 0 if all(r["status"] == "ok" for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
