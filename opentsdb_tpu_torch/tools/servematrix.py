"""Serve-tier fault matrix of the port: failover proven against a LIVE
deployment.

The port's copy of the JAX package's ``scripts/servematrix.py``, which
spawns the JAX CLI: this one spawns the port's
(``python -m opentsdb_tpu_torch.tools.cli``), its daemons on ``--device``
(``cuda`` by default, as every entry point of the port; ``--device cpu``
runs the whole matrix without a card), with the same scenarios, oracles,
gates and fingerprints.

Boots the real topology as separate OS processes — one writer daemon,
two streaming replicas (``tsd --role replica``, WAL-tailing with a
bounded staleness contract), one router (``tsd --role router``) — runs
a seeded ingest workload over real sockets, then injures the fleet and
verifies the contracts:

  replica-kill        SIGKILL the owner replica while its query is in
                      flight (a delay faultpoint armed over HTTP via
                      /fault holds the query open); the router must
                      retry onto
                      the surviving replica and answer BIT-IDENTICALLY
                      to the writer, then readmit the replica once
                      restarted.
  router-partition    SIGSTOP one replica (a partition as the router
                      sees it: connects hang, probes time out); the
                      router must eject it, serve its queries from the
                      other replica within the deadline, and readmit
                      after SIGCONT.
  writer-crash        SIGKILL the writer mid-ingest-stream; replicas
                      keep serving every ACKNOWLEDGED point (golden vs
                      the ack log), fsck over the crashed store is
                      clean (--expect-clean), and a restarted writer
                      reconverges with the fleet.
  staleness-contract  Wedge both replicas' refresh (ioerror faultpoint
                      armed over /fault), keep ingesting acknowledged
                      points, outwait the bound: every router answer
                      must now carry the "stale" tag — the BOUNDED-
                      STALENESS ORACLE. ``--bug stale-serve`` starts
                      the replicas with the tagging sabotaged
                      (TSDB_SERVE_BUG) and the oracle must CATCH the
                      untagged stale answer — the matrix's gate.

Cluster failover scenarios (opentsdb_tpu/cluster/; each boots a FRESH
--cluster deployment, since a promotion permanently changes who the
writer is):

  writer-promote      SIGKILL the writer mid-stream; the router must
                      promote a replica within the grace, flip ingest
                      forwarding to it (proven by ingesting THROUGH
                      the router afterwards), every acked point stays
                      queryable (durability oracle), and the old
                      writer restarted as a replica reconverges.
  zombie-fence        SIGSTOP the writer (wedged, alive, flock held);
                      the router promotes past the grace; SIGCONT
                      wakes the zombie, whose direct put must be
                      REFUSED (epoch fence) and which must end up
                      demoted to a tailing replica. ``--bug
                      split-brain`` disables the fence + demote
                      compliance (TSDB_CLUSTER_BUG) and the matrix
                      must CATCH the deposed writer acking a write
                      the cluster cannot serve — the cluster gate.
  promote-crash       Arm cluster.promote.rotate=crash on the first
                      promotion candidate over /fault; the candidate
                      dies MID-PROMOTION and the router must walk to
                      the next replica, which takes over at a higher
                      epoch with every acked point intact.

Scenario outcomes are seed-deterministic: the workload derives from
--seed, answers are hashed into per-scenario fingerprints, and two
runs with the same seed produce the same fingerprints.

    python -m opentsdb_tpu_torch.tools.servematrix --device cpu   # all
    python -m opentsdb_tpu_torch.tools.servematrix --device cpu --fast
    python -m opentsdb_tpu_torch.tools.servematrix --device cpu \
        --only staleness --bug stale-serve
    python -m opentsdb_tpu_torch.tools.servematrix --device cpu \
        --only zombie --bug split-brain

The artifact (``--json``) goes to ``<work dir>/serve_matrix.json`` unless
named.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CLI = "opentsdb_tpu_torch.tools.cli"

BT = 1356998400
# Cluster scenarios each boot a FRESH deployment (a promotion changes
# who the writer is for good); the legacy four share one.
CLUSTER = ("writer-promote", "zombie-fence", "promote-crash")
# Rollup-backed deployment (writer folds on a 2 s checkpoint timer,
# replicas serve the tier read-only): the bounded-error ladder row.
ROLLUP = ("degraded-approx",)
FAST = ("replica-kill", "router-partition", "writer-promote",
        "zombie-fence", "degraded-approx")
ALL = ("replica-kill", "router-partition", "writer-crash",
       "staleness-contract") + CLUSTER + ROLLUP
BUGS = ("stale-serve", "split-brain")
MAX_STALENESS_MS = 1200.0
WRITER_GRACE_MS = 1000.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def series_hash(b: bytes) -> int:
    """The router's ownership hash (``serve/router.series_hash``)."""
    return zlib.crc32(b)


def owner_metric(owner: int, salt: int = 0,
                 n_backends: int = 2) -> str:
    """The ``salt``-th m-spec owned by backend ``owner``. Scenarios
    share one live deployment, so each uses its OWN metric — reusing
    one with different seeded values would plant conflicting
    duplicates."""
    found = 0
    for i in range(1000):
        m = f"sum:serve.m{i}"
        if series_hash(m.encode()) % n_backends == owner:
            if found == salt:
                return m
            found += 1
    raise AssertionError


def http_get(port: int, target: str, timeout: float = 30.0):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{target}")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def telnet_acked(port: int, lines: list[str],
                 timeout: float = 60.0) -> None:
    """Send put lines and BLOCK until the daemon acknowledged them
    (the version round-trip drains the per-connection pipeline —
    everything sent before it has been applied or error-reported)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    s.settimeout(timeout)
    try:
        payload = "".join(ln + "\n" for ln in lines).encode()
        s.sendall(payload)
        s.sendall(b"version\n")
        buf = b""
        while b"net.opentsdb" not in buf and b"opentsdb" not in buf:
            chunk = s.recv(4096)
            if not chunk:
                raise RuntimeError(f"daemon closed during ack; "
                                   f"got {buf[-400:]!r}")
            buf += chunk
        if b"put:" in buf:
            raise RuntimeError(f"puts rejected: {buf[-400:]!r}")
    finally:
        s.close()


def wait_ready(proc, logpath: str, name: str, timeout: float = 180.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with open(logpath) as f:
                for ln in f:
                    if ln.startswith("Ready to serve on ") \
                            and ln.endswith("\n"):
                        try:
                            return int(ln.strip().rsplit(":", 1)[1])
                        except ValueError:
                            pass
        except OSError:
            pass
        if proc.poll() is not None:
            tail = ""
            try:
                tail = open(logpath).read()[-2000:]
            except OSError:
                pass
            raise RuntimeError(f"{name} died during startup: {tail}")
        time.sleep(0.2)
    raise RuntimeError(f"{name} never came up")


def answer_hash(body: bytes) -> str:
    """Stable hash of a /q json answer (dps only, ordered)."""
    res = json.loads(body)
    canon = [(r["metric"], sorted(r.get("tags", {}).items()),
              sorted((int(k), v) for k, v in r["dps"].items()))
             for r in res]
    canon.sort()
    return hashlib.sha1(json.dumps(canon).encode()).hexdigest()


class Deployment:
    """writer + 2 replicas + router, each its own OS process."""

    def __init__(self, workdir: str, seed: int, device: str,
                 bug: str | None = None,
                 router_args: list[str] | None = None,
                 rollups: bool = False,
                 cluster: bool = False) -> None:
        self.workdir = workdir
        self.seed = seed
        self.device = device
        self.bug = bug
        self.router_args = list(router_args or [])
        # rollups=True: writer folds the tier on a short checkpoint
        # timer and replicas serve it read-only (the bench topology;
        # the failover scenarios run raw to keep boot deterministic).
        self.rollups = rollups
        # cluster=True: every daemon joins the epoch-fenced write tier
        # (--cluster) and the router drives automatic failover
        # (--writer-grace-ms).
        self.cluster = cluster
        self.store = os.path.join(workdir, "store")
        self.procs: dict[str, subprocess.Popen] = {}
        self.ports: dict[str, int] = {}
        self.env = dict(
            os.environ,
            PYTHONPATH=REPO + os.pathsep
            + os.environ.get("PYTHONPATH", ""))
        self.env.pop("TSDB_FAULTPOINTS", None)

    def _spawn(self, name: str, args: list[str],
               extra_env: dict | None = None) -> int:
        logpath = os.path.join(self.workdir, f"{name}.log")
        env = dict(self.env, **(extra_env or {}))
        proc = subprocess.Popen(
            [sys.executable, "-m", CLI, "tsd", "--bind", "127.0.0.1",
             "--backend", "cpu", "--device", self.device] + args,
            env=env, stdout=open(logpath, "w"),
            stderr=subprocess.STDOUT, cwd=REPO)
        self.procs[name] = proc
        port = wait_ready(proc, logpath, name)
        self.ports[name] = port
        return port

    def start(self) -> None:
        os.makedirs(self.store, exist_ok=True)
        cluster_args = ["--cluster"] if self.cluster else []
        writer_args = ["--port", "0", "--wal",
                       os.path.join(self.store, "wal"),
                       "--auto-metric"] + cluster_args
        rollup_args = (["--rollups", "--checkpoint-interval", "2"]
                       if self.rollups else [])
        # The cluster gate sabotages the WRITER's fence (an unfenced
        # zombie); the serve gate sabotages the replicas' stale tag.
        writer_env = ({"TSDB_CLUSTER_BUG": self.bug}
                      if self.bug == "split-brain" else None)
        rep_env = ({"TSDB_SERVE_BUG": self.bug}
                   if self.bug and self.bug != "split-brain" else None)
        self._spawn("writer", writer_args + rollup_args,
                    extra_env=writer_env)
        for name in ("replica-a", "replica-b"):
            self._spawn(name, [
                "--port", "0", "--wal",
                os.path.join(self.store, "wal"),
                "--role", "replica",
                "--max-staleness-ms", str(MAX_STALENESS_MS),
                "--tail-interval", "0.1"] + cluster_args
                + (["--rollups"] if self.rollups else []),
                extra_env=rep_env)
        self._spawn("router", [
            "--port", "0", "--role", "router",
            "--backends",
            f"http://127.0.0.1:{self.ports['replica-a']},"
            f"http://127.0.0.1:{self.ports['replica-b']}",
            "--writer-url",
            f"http://127.0.0.1:{self.ports['writer']}",
            "--probe-interval", "0.2",
            "--router-eject-after", "2",
            "--router-retries", "2",
            "--router-deadline-ms", "8000"]
            + (["--writer-grace-ms", str(WRITER_GRACE_MS)]
               if self.cluster else [])
            + self.router_args)

    def restart(self, name: str, extra: list[str] | None = None,
                role: str | None = None) -> int:
        """Restart a daemon on its OLD port (the router's backend list
        is positional-by-URL). ``role`` overrides the daemon's role —
        a deposed writer comes back as ``--role replica``."""
        if role is None:
            role = "writer" if name == "writer" else "replica"
        port = self.ports[name]
        args = ["--port", str(port), "--wal",
                os.path.join(self.store, "wal")]
        if role == "replica":
            args += ["--role", "replica",
                     "--max-staleness-ms", str(MAX_STALENESS_MS),
                     "--tail-interval", "0.1"]
        else:
            args.append("--auto-metric")
        if self.cluster:
            args.append("--cluster")
        rep_env = ({"TSDB_SERVE_BUG": self.bug}
                   if self.bug and self.bug != "split-brain"
                   and role == "replica" else None)
        return self._spawn(name, args + (extra or []),
                           extra_env=rep_env)

    def kill(self, name: str) -> None:
        self.procs[name].send_signal(signal.SIGKILL)
        self.procs[name].wait(timeout=30)

    def stop(self) -> None:
        for name, p in self.procs.items():
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGCONT)
                except OSError:
                    pass
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()

    # -- workload ------------------------------------------------------

    def ingest_acked(self, metric: str, n: int, t0: int,
                     vbase: int) -> None:
        """Seeded, acknowledged points (value = (vbase + i) % 97)."""
        lines = [f"put {metric} {t0 + i * 60} {(vbase + i) % 97} "
                 f"host=h" for i in range(n)]
        telnet_acked(self.ports["writer"], lines)

    def wait_backend_state(self, idx: int, healthy: bool,
                           timeout: float = 30.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                _, _, body = http_get(self.ports["router"], "/healthz",
                                      timeout=5)
                b = json.loads(body)["backends"][idx]
                if b["healthy"] == healthy:
                    return True
            except Exception:
                pass
            time.sleep(0.1)
        return False


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------

def _golden(dep: Deployment, m: str, end_n: int) -> str:
    """The writer's own answer hash for the scenario query."""
    q = (f"/q?start={BT - 60}&end={BT + end_n * 60}&m={m}"
         f"&json&nocache")
    status, _, body = http_get(dep.ports["writer"], q)
    assert status == 200, (status, body[:300])
    return answer_hash(body)


def _router_q(dep: Deployment, m: str, end_n: int,
              timeout: float = 30.0):
    q = (f"/q?start={BT - 60}&end={BT + end_n * 60}&m={m}"
         f"&json&nocache")
    return http_get(dep.ports["router"], q, timeout=timeout)


def scenario_replica_kill(dep: Deployment, seed: int) -> dict:
    problems: list[str] = []
    m0 = owner_metric(0)
    n = 400
    dep.ingest_acked(m0.split(":", 1)[1], n, BT, seed % 97)
    time.sleep(0.5)  # a tail cycle
    golden = _golden(dep, m0, n)

    # Arm a delay over HTTP on the OWNER replica so its in-flight
    # query is still running when the SIGKILL lands (the /fault
    # integration against a live multi-process deployment).
    status, _, body = http_get(
        dep.ports["replica-a"],
        "/fault?arm=query.scan%3Ddelay%3Adelay%3D5.0%3Acount%3D10")
    if status != 200 or b"query.scan" not in body:
        problems.append(f"arm-over-HTTP failed: {status} {body[:200]}")

    import threading
    out: dict = {}

    def query():
        try:
            out["res"] = _router_q(dep, m0, n, timeout=60)
        except Exception as e:
            out["err"] = repr(e)

    t = threading.Thread(target=query)
    t.start()
    time.sleep(0.8)      # hop reached the wedged replica
    dep.kill("replica-a")
    t.join(timeout=60)
    if "err" in out:
        problems.append(f"router query died with {out['err']}")
    else:
        status, headers, body = out["res"]
        if status != 200:
            problems.append(
                f"router answered {status} after replica kill: "
                f"{body[:200]}")
        elif answer_hash(body) != golden:
            problems.append("failover answer != writer answer")
    # Restart on the old port; the router must readmit.
    dep.restart("replica-a")
    if not dep.wait_backend_state(0, healthy=True):
        problems.append("killed replica never readmitted after "
                        "restart")
    return {"problems": problems,
            "fingerprint_parts": [golden]}


def scenario_router_partition(dep: Deployment, seed: int) -> dict:
    problems: list[str] = []
    m1 = owner_metric(1)
    n = 400
    dep.ingest_acked(m1.split(":", 1)[1], n, BT, seed % 89)
    time.sleep(0.5)
    golden = _golden(dep, m1, n)

    # Partition: the replica hangs (SIGSTOP) — connects succeed but
    # nothing answers, which is what a network partition looks like
    # from the router's side.
    dep.procs["replica-b"].send_signal(signal.SIGSTOP)
    try:
        if not dep.wait_backend_state(1, healthy=False):
            problems.append("partitioned replica never ejected")
        t0 = time.time()
        status, _, body = _router_q(dep, m1, n, timeout=60)
        wall = time.time() - t0
        if status != 200:
            problems.append(
                f"router answered {status} during partition")
        elif answer_hash(body) != golden:
            problems.append("partition failover answer != writer")
        if wall > 10.0:
            problems.append(
                f"partition failover took {wall:.1f}s (> deadline "
                f"budget)")
    finally:
        dep.procs["replica-b"].send_signal(signal.SIGCONT)
    if not dep.wait_backend_state(1, healthy=True):
        problems.append("healed replica never readmitted")
    return {"problems": problems, "fingerprint_parts": [golden]}


def scenario_writer_crash(dep: Deployment, seed: int) -> dict:
    problems: list[str] = []
    m0 = owner_metric(0, salt=1)
    metric = m0.split(":", 1)[1]
    # Acked prefix, then the crash. Every acked point must survive.
    n_acked = 300
    dep.ingest_acked(metric, n_acked, BT, seed % 83)
    dep.kill("writer")
    # Replicas keep serving the acked history (tail catches up to the
    # durable WAL end; a dead writer is NOT staleness).
    time.sleep(1.0)
    status, headers, body = _router_q(dep, m0, n_acked)
    if status != 200:
        problems.append(f"router {status} with writer dead")
    else:
        res = json.loads(body)
        got = sum(len(r["dps"]) for r in res)
        if got != n_acked:
            problems.append(
                f"replica serves {got}/{n_acked} acked points with "
                f"writer dead (tag: "
                f"{headers.get('X-Tsd-Degraded')!r})")
    # The crashed store recovers clean: the operator tool, verbatim.
    fsck = subprocess.run(
        [sys.executable, "-m", CLI, "fsck",
         "--wal", os.path.join(dep.store, "wal"), "--backend", "cpu",
         "--device", dep.device, "--expect-clean"],
        env=dep.env, capture_output=True, cwd=REPO, timeout=120)
    if fsck.returncode != 0:
        problems.append(
            f"fsck --expect-clean exit {fsck.returncode}: "
            f"{fsck.stdout.decode()[-300:]}")
    # Restarted writer reconverges with the fleet.
    dep.restart("writer")
    dep.ingest_acked(metric, 50, BT + n_acked * 60, 7)
    time.sleep(0.8)
    golden = _golden(dep, m0, n_acked + 50)
    status, _, body = _router_q(dep, m0, n_acked + 50)
    if status != 200 or answer_hash(body) != golden:
        problems.append("post-restart router answer != writer")
    return {"problems": problems, "fingerprint_parts": [golden]}


def scenario_staleness_contract(dep: Deployment, seed: int) -> dict:
    """THE bounded-staleness oracle. Wedge every replica's refresh,
    ingest acknowledged points, outwait the bound: an untagged answer
    that is missing acked-and-older-than-the-bound records is a
    CONTRACT VIOLATION (exactly what --bug stale-serve fabricates)."""
    problems: list[str] = []
    m0 = owner_metric(0, salt=2)
    metric = m0.split(":", 1)[1]
    n0 = 200
    dep.ingest_acked(metric, n0, BT, seed % 79)
    time.sleep(0.5)
    for rep in ("replica-a", "replica-b"):
        status, _, body = http_get(
            dep.ports[rep],
            "/fault?arm=replica.refresh%3Dioerror%3Acount%3D100000")
        if status != 200:
            problems.append(f"/fault arm on {rep} failed: {status}")
    try:
        # New ACKED points the wedged replicas can never see.
        n1 = 100
        dep.ingest_acked(metric, n1, BT + n0 * 60, 13)
        t_ack = time.time()
        # Outwait the contract bound (plus a tail interval of slack).
        while (time.time() - t_ack) * 1000 <= MAX_STALENESS_MS + 400:
            time.sleep(0.1)
        status, headers, body = _router_q(dep, m0, n0 + n1)
        if status != 200:
            problems.append(f"router {status} during staleness test")
        else:
            res = json.loads(body)
            got = sum(len(r["dps"]) for r in res)
            tagged = "stale" in (headers.get("X-Tsd-Degraded") or "")
            missing = got < n0 + n1
            if missing and not tagged:
                problems.append(
                    f"STALENESS CONTRACT VIOLATION: answer reflects "
                    f"{got}/{n0 + n1} acknowledged points, every "
                    f"missing one acked "
                    f">{MAX_STALENESS_MS:.0f}ms ago, and carries NO "
                    f"stale tag")
            if not missing:
                problems.append(
                    "vacuous staleness run: the wedged replicas "
                    "somehow saw the new points")
    finally:
        for rep in ("replica-a", "replica-b"):
            try:
                http_get(dep.ports[rep], "/fault?clear=1", timeout=5)
            except Exception:
                pass
    return {"problems": problems, "fingerprint_parts": []}


# ---------------------------------------------------------------------------
# Cluster failover scenarios (fresh --cluster deployment each)
# ---------------------------------------------------------------------------

def wait_promotion(dep: Deployment, timeout: float = 30.0):
    """Poll /api/topology until the router reports a promotion;
    returns (promoted_url, epoch) or (None, 0)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            _, _, body = http_get(dep.ports["router"], "/api/topology",
                                  timeout=5)
            promo = json.loads(body).get("promotion") or {}
            for ev in promo.get("events", []):
                if ev.get("event") == "promoted":
                    return ev["url"], promo.get("epoch", 0)
        except Exception:
            pass
        time.sleep(0.1)
    return None, 0


def wait_point_count(port: int, m: str, end_n: int, want: int,
                     timeout: float = 30.0) -> int:
    """Poll a daemon's /q until it serves ``want`` points (the ack
    boundary for ingest routed through the router, whose telnet
    forwarding acks asynchronously)."""
    deadline = time.time() + timeout
    got = -1
    q = (f"/q?start={BT - 60}&end={BT + end_n * 60}&m={m}"
         f"&json&nocache")
    while time.time() < deadline:
        try:
            status, _, body = http_get(port, q, timeout=10)
            if status == 200:
                got = sum(len(r["dps"]) for r in json.loads(body))
                if got >= want:
                    return got
        except Exception:
            pass
        time.sleep(0.2)
    return got


def telnet_try_put(port: int, line: str, timeout: float = 15.0) -> bytes:
    """Send one put + version; return whatever came back (the caller
    decides whether a ``put:`` error line was the right answer)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    s.settimeout(timeout)
    try:
        s.sendall((line + "\nversion\n").encode())
        buf = b""
        while b"opentsdb" not in buf:
            chunk = s.recv(4096)
            if not chunk:
                break
            buf += chunk
        return buf
    finally:
        s.close()


def scenario_writer_promote(dep: Deployment, seed: int) -> dict:
    """Writer SIGKILL → grace → replica promoted → ingest forwarding
    flips → acked-point durability oracle → deposed writer rejoins as
    a replica."""
    problems: list[str] = []
    m0 = owner_metric(0, salt=4)
    metric = m0.split(":", 1)[1]
    n0 = 300
    dep.ingest_acked(metric, n0, BT, seed % 71)
    time.sleep(0.5)  # a tail cycle: replicas hold everything durable
    dep.kill("writer")
    promoted, epoch = wait_promotion(dep)
    if promoted is None:
        return {"problems": ["router never promoted a replica after "
                             "the writer died"],
                "fingerprint_parts": []}
    if epoch < 2:
        problems.append(f"promotion did not bump the epoch "
                        f"(topology says {epoch})")
    promoted_name = next(
        (n for n in ("replica-a", "replica-b")
         if str(dep.ports[n]) in promoted), None)
    if promoted_name is None:
        problems.append(f"promoted url {promoted!r} is not a replica")
        return {"problems": problems, "fingerprint_parts": []}
    # Ingest THROUGH THE ROUTER: proves telnet forwarding flipped to
    # the promoted writer (the old writer is a corpse).
    n1 = 100
    lines = [f"put {metric} {BT + (n0 + i) * 60} {(13 + i) % 97} "
             f"host=h" for i in range(n1)]
    telnet_acked(dep.ports["router"], lines)
    got = wait_point_count(dep.ports[promoted_name], m0, n0 + n1,
                           n0 + n1)
    if got != n0 + n1:
        problems.append(
            f"DURABILITY: promoted writer serves {got}/{n0 + n1} "
            f"acked points")
    # The promoted writer is the authority now; the router must agree.
    q = (f"/q?start={BT - 60}&end={BT + (n0 + n1) * 60}&m={m0}"
         f"&json&nocache")
    _, _, direct = http_get(dep.ports[promoted_name], q)
    golden = answer_hash(direct)
    status, _, via_router = _router_q(dep, m0, n0 + n1)
    if status != 200 or answer_hash(via_router) != golden:
        problems.append("router answer != promoted writer answer")
    # The deposed writer's way back: restart on its old port as a
    # replica; it must tail the promoted writer's WAL and converge.
    dep.restart("writer", role="replica")
    got = wait_point_count(dep.ports["writer"], m0, n0 + n1, n0 + n1)
    if got != n0 + n1:
        problems.append(
            f"restarted old writer (as replica) serves {got}/"
            f"{n0 + n1} points — never converged")
    return {"problems": problems, "fingerprint_parts": [golden]}


def scenario_zombie_fence(dep: Deployment, seed: int) -> dict:
    """THE split-brain oracle. Wedge the writer (SIGSTOP — alive,
    flock held, /healthz dark), let the router promote past the
    grace, wake the zombie: its direct put must be REFUSED (the epoch
    fence), and it must end up demoted to a tailing replica. --bug
    split-brain disables the fence and demote compliance
    (TSDB_CLUSTER_BUG) and this scenario must CATCH the zombie acking
    a write the cluster cannot serve."""
    problems: list[str] = []
    m0 = owner_metric(1, salt=4)
    metric = m0.split(":", 1)[1]
    n0 = 250
    dep.ingest_acked(metric, n0, BT, seed % 67)
    time.sleep(0.5)
    dep.procs["writer"].send_signal(signal.SIGSTOP)
    try:
        promoted, epoch = wait_promotion(dep)
        if promoted is None:
            return {"problems": ["router never promoted past a wedged "
                                 "writer"],
                    "fingerprint_parts": []}
        promoted_name = next(
            (n for n in ("replica-a", "replica-b")
             if str(dep.ports[n]) in promoted), "replica-a")
        # Acked points the NEW writer owns.
        n1 = 50
        lines = [f"put {metric} {BT + (n0 + i) * 60} {(7 + i) % 97} "
                 f"host=h" for i in range(n1)]
        telnet_acked(dep.ports[promoted_name], lines)
    finally:
        dep.procs["writer"].send_signal(signal.SIGCONT)
    # The zombie wakes with a stale epoch. Its OWN ingest port must
    # refuse the put — fenced (or already demoted; both mean no split
    # brain). An ack here is THE violation.
    zombie_line = (f"put {metric} {BT + (n0 + 500) * 60} 55 host=h")
    back = telnet_try_put(dep.ports["writer"], zombie_line)
    if b"put:" not in back:
        # The zombie acked. Is the point actually servable?
        time.sleep(1.0)
        got = wait_point_count(dep.ports[promoted_name], m0,
                               n0 + 501, n0 + n1 + 1, timeout=3.0)
        problems.append(
            f"SPLIT BRAIN: deposed writer ACKNOWLEDGED a write "
            f"(cluster serves {got}/{n0 + n1 + 1} points incl. it "
            f"— the acked point is "
            f"{'lost' if got < n0 + n1 + 1 else 'duplicated'})")
    # Demote-on-return: the router owes the zombie a /demote; it must
    # end up a tailing replica (skip under the bug — sabotaged).
    if dep.bug != "split-brain":
        deadline = time.time() + 20
        role = None
        while time.time() < deadline:
            try:
                _, _, body = http_get(dep.ports["writer"], "/healthz",
                                      timeout=5)
                role = json.loads(body).get("role")
                if role == "replica":
                    break
            except Exception:
                pass
            time.sleep(0.2)
        if role != "replica":
            problems.append(f"zombie writer never demoted to tailing "
                            f"(healthz role: {role!r})")
        else:
            got = wait_point_count(dep.ports["writer"], m0, n0 + 51,
                                   n0 + 50)
            if got != n0 + 50:
                problems.append(
                    f"demoted writer serves {got}/{n0 + 50} points — "
                    f"tailing never converged")
    return {"problems": problems, "fingerprint_parts": []}


def scenario_promote_crash(dep: Deployment, seed: int) -> dict:
    """A promotion candidate dying MID-PROMOTION (cluster.promote.
    rotate=crash armed over /fault) must not strand the cluster: the
    router walks to the next replica, which takes over at a higher
    epoch with every acked point intact."""
    problems: list[str] = []
    m0 = owner_metric(0, salt=5)
    metric = m0.split(":", 1)[1]
    n0 = 200
    dep.ingest_acked(metric, n0, BT, seed % 61)
    time.sleep(0.5)
    # The router's candidate walk probes replica-a first: arm its
    # rotate site to kill it at the worst moment (epoch already
    # bumped, WAL mid-rotation).
    status, _, body = http_get(
        dep.ports["replica-a"],
        "/fault?arm=cluster.promote.rotate%3Dcrash")
    if status != 200 or b"cluster.promote.rotate" not in body:
        problems.append(f"arm-over-HTTP failed: {status} {body[:200]}")
    dep.kill("writer")
    promoted, epoch = wait_promotion(dep, timeout=60.0)
    if promoted is None:
        return {"problems": ["router never promoted anyone (candidate "
                             "crash stranded the failover)"],
                "fingerprint_parts": []}
    if str(dep.ports["replica-b"]) not in promoted:
        problems.append(f"expected replica-b promoted after "
                        f"replica-a's injected crash, got {promoted!r}")
    if dep.procs["replica-a"].poll() is None:
        problems.append("replica-a survived an armed crash "
                        "faultpoint (site never fired)")
    got = wait_point_count(dep.ports["replica-b"], m0, n0, n0)
    if got != n0:
        problems.append(f"DURABILITY: promoted replica-b serves "
                        f"{got}/{n0} acked points")
    # The crashed candidate recovers as a replica over the store the
    # new writer now owns (crash recovery mid-rotation is the
    # idempotent-replay contract).
    dep.restart("replica-a")
    got = wait_point_count(dep.ports["replica-a"], m0, n0, n0)
    if got != n0:
        problems.append(f"crashed candidate recovered serving "
                        f"{got}/{n0} points")
    return {"problems": problems, "fingerprint_parts": []}


def _wait_stats_value(port: int, name: str, want: float,
                      timeout: float = 60.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            _, _, body = http_get(port, "/stats", timeout=5)
            for ln in body.decode("utf-8", "replace").splitlines():
                parts = ln.split()
                if len(parts) >= 3 and parts[0] == name:
                    if float(parts[2]) == want:
                        return True
        except Exception:
            pass
        time.sleep(0.2)
    return False


def scenario_degraded_approx(dep: Deployment, seed: int) -> dict:
    """Ladder semantics, live: at the rollup-only degradation step a
    pNN query comes back 200, tagged ``degraded`` AND ``approx``
    with a numeric bound that CONTAINS the writer's exact answer —
    not a silent partial, not a 503 — while a raw-only query at the
    same step still sheds 503 + Retry-After (the declared ladder)."""
    problems: list[str] = []
    metric = "deg.p95.m"
    n = 360  # six 1h windows of minutely points
    dep.ingest_acked(metric, n, BT, seed % 89)
    # Quiesce: the writer's 2 s checkpoint timer folds the tier, the
    # replicas adopt it read-only via the tailer.
    if not _wait_stats_value(dep.ports["writer"],
                             "tsd.rollup.ready", 1):
        problems.append("writer rollup tier never became ready")
    if not _wait_stats_value(dep.ports["writer"],
                             "tsd.dirty_set.size", 0):
        problems.append("writer never quiesced (dirty windows left)")
    for rep in ("replica-a", "replica-b"):
        if not _wait_stats_value(dep.ports[rep],
                                 "tsd.rollup.ready", 1):
            problems.append(f"{rep} rollup tier never became ready")
    if problems:
        return {"problems": problems, "fingerprint_parts": []}
    m = f"max:1h-p95:{metric}"
    q = f"/q?start={BT - 60}&end={BT + n * 60}&m={m}&json&nocache"
    status, _, body = http_get(dep.ports["writer"], q)
    if status != 200:
        return {"problems": [f"writer exact pNN query {status}"],
                "fingerprint_parts": []}
    exact = json.loads(body)
    exact_dps = {}
    for ent in exact:
        exact_dps.update(ent["dps"])
    golden = answer_hash(body)
    status, headers, body = http_get(
        dep.ports["router"], q + "&degrade=rollup-only", timeout=30)
    if status != 200:
        problems.append(
            f"degraded pNN query answered {status} (the bounded-"
            f"error step must serve): {body[:200]}")
        return {"problems": problems, "fingerprint_parts": [golden]}
    if "rollup-only" not in (headers.get("X-Tsd-Degraded") or ""):
        problems.append("degraded answer missing X-Tsd-Degraded")
    if not headers.get("X-Tsd-Approx"):
        problems.append("degraded answer missing X-Tsd-Approx")
    res = json.loads(body)
    buckets = 0
    for ent in res:
        if "rollup-only" not in (ent.get("degraded") or ""):
            problems.append("result missing degraded tag")
        ap = ent.get("approx")
        if (not ap or ap.get("kind") not in ("tdigest", "moment")
                or not isinstance(ap.get("error"), (int, float))):
            problems.append(
                f"result missing numeric approx bound: {ap}")
            continue
        for ts_s, v in ent["dps"].items():
            buckets += 1
            ev = exact_dps.get(ts_s)
            if ev is None:
                problems.append(f"approx bucket {ts_s} absent from "
                                f"the exact answer")
            elif abs(ev - v) > ap["error"] + 1e-9:
                problems.append(
                    f"BOUND VIOLATION at {ts_s}: exact={ev} "
                    f"approx={v} reported_error={ap['error']}")
    if buckets == 0:
        problems.append("degraded pNN answer was an empty/silent "
                        "partial")
    # The ladder's other face: raw-only work still sheds, loudly.
    status2, h2, b2 = http_get(
        dep.ports["router"],
        f"/q?start={BT - 60}&end={BT + n * 60}&m=sum:{metric}"
        f"&json&nocache&degrade=rollup-only", timeout=30)
    if status2 != 503:
        problems.append(f"raw-only degraded query got {status2}, "
                        f"want 503: {b2[:200]}")
    elif not h2.get("Retry-After"):
        problems.append("503 without Retry-After")
    return {"problems": problems, "fingerprint_parts": [golden]}


SCENARIOS = {
    "replica-kill": scenario_replica_kill,
    "router-partition": scenario_router_partition,
    "writer-crash": scenario_writer_crash,
    "staleness-contract": scenario_staleness_contract,
    "writer-promote": scenario_writer_promote,
    "zombie-fence": scenario_zombie_fence,
    "promote-crash": scenario_promote_crash,
    "degraded-approx": scenario_degraded_approx,
}


def _run_one(dep: Deployment, label: str, seed: int,
             bug: str | None) -> dict:
    t0 = time.time()
    try:
        out = SCENARIOS[label](dep, seed)
    except Exception as e:
        import traceback
        out = {"problems": [f"scenario crashed: {e!r}",
                            traceback.format_exc(limit=5)],
               "fingerprint_parts": []}
    status = "ok" if not out["problems"] else "invariant-failed"
    fp = hashlib.sha1(
        ("|".join([label, status] + out["problems"]
                  + out["fingerprint_parts"])).encode()).hexdigest()
    rec = {
        "label": label, "status": status,
        "problems": out["problems"],
        "seed": seed, "bug": bug,
        "wall_s": round(time.time() - t0, 2),
        "fingerprint": fp,
        "repro": (f"python -m opentsdb_tpu_torch.tools.servematrix "
                  f"--device {dep.device} --only {label} --seed {seed}"
                  + (f" --bug {bug}" if bug else "")),
    }
    log(f"{status:17s} {label} ({rec['wall_s']:.1f}s)")
    return rec


def run(labels, workdir: str, seed: int, bug: str | None,
        device: str) -> list[dict]:
    os.makedirs(workdir, exist_ok=True)
    results = []
    for label in (lb for lb in labels if lb in ROLLUP):
        dep = Deployment(os.path.join(workdir, label), seed, device,
                         bug=bug, rollups=True)
        log(f"booting ROLLUP deployment for {label} ...")
        dep.start()
        try:
            results.append(_run_one(dep, label, seed, bug))
        finally:
            dep.stop()
    legacy = [lb for lb in labels
              if lb not in CLUSTER and lb not in ROLLUP]
    if legacy:
        dep = Deployment(os.path.join(workdir, "legacy"), seed, device,
                         bug=bug)
        log("booting writer + 2 replicas + router ...")
        dep.start()
        try:
            for label in legacy:
                results.append(_run_one(dep, label, seed, bug))
        finally:
            dep.stop()
    for label in (lb for lb in labels if lb in CLUSTER):
        dep = Deployment(os.path.join(workdir, label), seed, device,
                         bug=bug, cluster=True)
        log(f"booting CLUSTER deployment for {label} ...")
        dep.start()
        try:
            results.append(_run_one(dep, label, seed, bug))
        finally:
            dep.stop()
    # Preserve the requested label order in the artifact.
    order = {lb: i for i, lb in enumerate(labels)}
    results.sort(key=lambda r: order[r["label"]])
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", default=None,
                   help="artifact path (default: serve_matrix.json in "
                        "the work directory)")
    p.add_argument("--fast", action="store_true",
                   help="tier-1 subset: replica-kill + "
                        "router-partition + writer-promote + "
                        "zombie-fence")
    p.add_argument("--cluster", action="store_true",
                   help="cluster failover scenarios only "
                        "(writer-promote, zombie-fence, "
                        "promote-crash)")
    p.add_argument("--only", action="append", default=[])
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--bug", default=None, choices=BUGS,
                   help="sabotage the replicas (TSDB_SERVE_BUG) so "
                        "the oracle must catch the violation — the "
                        "matrix's own gate; expect failures")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of every daemon (cuda or cpu)")
    p.add_argument("--list", action="store_true")
    args = p.parse_args(argv)

    labels = list(CLUSTER if args.cluster
                  else FAST if args.fast else ALL)
    if args.only:
        labels = [lb for lb in labels + [x for x in ALL
                                         if x not in labels]
                  if any(o in lb for o in args.only)]
    if args.list:
        for lb in labels:
            print(lb)
        return 0
    if not labels:
        print("no scenarios match", file=sys.stderr)
        return 2

    import tempfile
    work = args.work_dir or tempfile.mkdtemp(prefix="servematrix-")
    t0 = time.time()
    results = run(labels, work, args.seed, args.bug, args.device)
    dt = time.time() - t0
    passed = sum(1 for r in results if r["status"] == "ok")
    artifact = {
        "scenarios": len(results), "passed": passed,
        "failed": len(results) - passed,
        "wall_seconds": round(dt, 2),
        "fast": bool(args.fast), "seed": args.seed,
        "bug": args.bug, "device": args.device,
        "max_staleness_ms": MAX_STALENESS_MS,
        "results": results,
    }
    out_json = args.json or os.path.join(work, "serve_matrix.json")
    with open(out_json, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"\n{passed}/{len(results)} serve scenarios passed in "
          f"{dt:.1f}s -> {out_json}")
    for r in results:
        if r["status"] != "ok":
            print(f"  FAIL {r['label']}: {r['problems'][:2]}")
            print(f"       repro: {r['repro']}")
    return 0 if passed == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
