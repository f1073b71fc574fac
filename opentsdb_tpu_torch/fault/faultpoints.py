"""Failpoint registry: named fault-injection sites on the durability path.

Mirrors ``opentsdb_tpu/fault/faultpoints.py`` of the JAX package (the same
grammar, modes, schedules and torn offsets, so one spec arms the same
sites the same way in either package). Call sites in ``storage/kv.py``
(WAL append and fsync, the group commit's write and fsync, the three
checkpoint phases), ``storage/sstable.py`` (footer, body, rename),
``storage/sharded.py`` (per-shard spill joins), ``tenant/accounting.py``
(the snapshot's write and commit) and ``query/executor.py`` (the scan)
invoke ``fire(site)``. Unarmed, the production state, ``fire`` is one
empty-dict truthiness check and a return: the registry starts empty and
nothing fills it unless a test or the ``TSDB_FAULTPOINTS`` environment
variable arms a site, so the instrumentation costs nothing measurable on
the ingest path (one call per WAL batch, not per cell).

Armed, a site runs a deterministic schedule: the first ``skip`` hits pass
through, then ``count`` hits trigger the action:

    crash    os._exit(EXIT_CODE): process death, the flock drops, the page
             cache (and with it every flushed but not fsynced byte)
             survives, exactly what SIGKILL does to a daemon.
    torn     truncate the site's file inside its last record (a seeded
             number of bytes off the tail), then crash: the state a
             mid-write power cut leaves. Only sites that pass a (path,
             rec_bytes) context support it.
    raise    raise FaultInjected (in-process error paths: the spill's
             thaw, the manifest rollback).
    ioerror  raise OSError (the fsync-failed / disk-full shape).
    delay    sleep ``delay`` seconds and continue (race widening). A
             traced request records a ``fault.delay`` child span (tag
             ``site``) under the span current when it fires.

Schedules are per process and deterministic: the sharded store spills
serially while any site is armed, hits count up monotonically, and the
torn offset derives from the arming's ``seed`` and the hit number. The
harness (``fault/harness.py``) arms its child processes through
``TSDB_FAULTPOINTS``.

Spec grammar::

    site=mode[:skip=N][:count=N][:delay=SECS][:seed=N][;site2=...]
"""

from __future__ import annotations

import os
import threading
import time

EXIT_CODE = 137  # what SIGKILL would report; harness expects it
ENV_VAR = "TSDB_FAULTPOINTS"

MODES = ("crash", "torn", "raise", "ioerror", "delay")


class FaultInjected(Exception):
    """Raised by an armed ``raise``-mode failpoint."""


class _Arming:
    __slots__ = ("site", "mode", "skip", "count", "delay", "seed",
                 "hits", "fired")

    def __init__(self, site: str, mode: str, skip: int = 0,
                 count: int = 1, delay: float = 0.05,
                 seed: int = 0) -> None:
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r} "
                             f"(one of {', '.join(MODES)})")
        if skip < 0 or count < 1:
            raise ValueError(f"bad fault schedule skip={skip} "
                             f"count={count}")
        self.site = site
        self.mode = mode
        self.skip = skip
        self.count = count
        self.delay = delay
        self.seed = seed
        self.hits = 0    # total visits while armed
        self.fired = 0   # visits that triggered the action

    def snapshot(self) -> dict:
        return {"mode": self.mode, "skip": self.skip,
                "count": self.count, "delay": self.delay,
                "seed": self.seed, "hits": self.hits,
                "fired": self.fired}


_LOCK = threading.RLock()
_ARMED: dict[str, _Arming] = {}
# Cumulative per-site fired counts, surviving disarm/clear — the
# /stats export (fault.fired) and test assertions read these.
FIRED: dict[str, int] = {}


def active() -> bool:
    """Any site armed? Call sites that must serialize concurrent work
    for schedule determinism (the sharded spill pool) check this."""
    return bool(_ARMED)


def armed(site: str) -> bool:
    return site in _ARMED


def fire(site: str, path: str | None = None, rec_bytes: int = 0) -> None:
    """Hit a failpoint. The unarmed fast path is a dict truthiness
    check; ``path``/``rec_bytes`` give torn mode the file to cut and
    the byte span of its last record."""
    if not _ARMED:
        return
    _fire_armed(site, path, rec_bytes)


def _fire_armed(site: str, path: str | None, rec_bytes: int) -> None:
    with _LOCK:
        a = _ARMED.get(site)
        if a is None:
            return
        a.hits += 1
        if a.hits <= a.skip:
            return
        if a.fired >= a.count:
            return
        a.fired += 1
        FIRED[site] = FIRED.get(site, 0) + 1
        mode, delay = a.mode, a.delay
        # Seeded, hit-dependent, deterministic torn offset.
        torn_k = (a.seed * 2654435761 + a.hits * 40503) & 0x7FFFFFFF
    if mode == "crash":
        os._exit(EXIT_CODE)
    if mode == "torn":
        _tear(path, rec_bytes, torn_k)
        os._exit(EXIT_CODE)
    if mode == "raise":
        raise FaultInjected(f"failpoint {site}")
    if mode == "ioerror":
        raise OSError(f"injected I/O error at failpoint {site}")
    if mode == "delay":
        # The deterministic proof that exactly one stage stretched
        # (obs/trace.py). Imported here: the fault module stays light for
        # the crash harness's child processes.
        from opentsdb_tpu_torch.obs import trace as _obs_trace
        with _obs_trace.span("fault.delay", site=site):
            time.sleep(delay)


def _tear(path: str | None, rec_bytes: int, k: int) -> None:
    """Truncate ``path`` so the cut lands inside its last record (the
    last ``rec_bytes`` bytes): size - (1 + k % rec_bytes). A k that
    lands exactly at the record boundary removes the whole record — a
    clean crash-before-write state, also worth covering."""
    if not path:
        return
    try:
        size = os.path.getsize(path)
        span = min(max(rec_bytes, 1), size)
        cut = 1 + k % span
        os.truncate(path, max(size - cut, 0))
    except OSError:
        return  # non-file site context: torn degrades to plain crash


# -- arming ----------------------------------------------------------------

def arm(site: str, mode: str, skip: int = 0, count: int = 1,
        delay: float = 0.05, seed: int = 0) -> None:
    with _LOCK:
        _ARMED[site] = _Arming(site, mode, skip=skip, count=count,
                               delay=delay, seed=seed)


def disarm(site: str) -> bool:
    with _LOCK:
        return _ARMED.pop(site, None) is not None


def clear() -> None:
    with _LOCK:
        _ARMED.clear()


def status() -> dict:
    """JSON-ready registry snapshot (what the JAX daemon's /fault
    endpoint answers)."""
    with _LOCK:
        return {"armed": {s: a.snapshot() for s, a in _ARMED.items()},
                "fired": dict(FIRED)}


def parse_spec(spec: str) -> list[_Arming]:
    """Parse the spec grammar (module docstring) WITHOUT arming:
    validation before any state changes."""
    out = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        head, *opts = part.split(":")
        site, sep, mode = head.partition("=")
        if not sep or not site or not mode:
            raise ValueError(f"bad fault spec {part!r} "
                             f"(want site=mode[:k=v...])")
        kw: dict = {}
        for opt in opts:
            k, sep, v = opt.partition("=")
            if not sep:
                raise ValueError(f"bad fault option {opt!r} in {part!r}")
            if k in ("skip", "count", "seed"):
                kw[k] = int(v)
            elif k == "delay":
                kw[k] = float(v)
            else:
                raise ValueError(f"unknown fault option {k!r} in "
                                 f"{part!r}")
        out.append(_Arming(site.strip(), mode.strip(), **kw))
    return out


def install_spec(spec: str) -> int:
    """Parse + arm every site in ``spec``; returns the number armed."""
    armings = parse_spec(spec)
    with _LOCK:
        for a in armings:
            _ARMED[a.site] = a
    return len(armings)


def format_spec(site: str, mode: str, skip: int = 0, count: int = 1,
                delay: float = 0.05, seed: int = 0) -> str:
    """One-site spec string (the harness builds child env vars with
    this, so the two grammars cannot drift)."""
    out = f"{site}={mode}"
    if skip:
        out += f":skip={skip}"
    if count != 1:
        out += f":count={count}"
    if mode == "delay":
        out += f":delay={delay}"
    if seed:
        out += f":seed={seed}"
    return out


# Child processes inherit their schedule through the environment: the
# harness sets TSDB_FAULTPOINTS before spawn and this module arms at
# first import (kv.py imports it, so arming precedes any storage work).
_env = os.environ.get(ENV_VAR)
if _env:
    install_spec(_env)
