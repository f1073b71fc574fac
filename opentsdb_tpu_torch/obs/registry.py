"""Process-wide metrics registry: counters, gauges, latency timers.

Mirrors ``opentsdb_tpu/obs/registry.py`` of the JAX package, copied rather
than imported: the port's ``METRICS`` is its own process-wide registry,
with the JAX package's instrument names, so one reader serves both.

Replaces the scattered per-object ``/stats`` counter plumbing with one
named registry the engine's modules register into at import time (the
faultpoints precedent: a module-level singleton storage/rollup/server
code can reach without threading a handle through every constructor).
Per-OBJECT stats (a store's shard count, an executor's cache hits)
stay on their objects and flow through ``collect_stats`` as before;
the registry owns the cross-cutting engine metrics — WAL append/fsync,
checkpoint phases, per-shard spills, rollup folds, fsck — and the
HTTP/telnet handler instruments.

Cost discipline: an un-polled registry costs one attribute increment
per counted event and one ``perf_counter`` pair + digest append per
timed event; every instrumented site fires per *batch* or per
*operation*, never per point. Rendering (``collect``,
``prometheus_text``) only runs when ``/stats`` / ``/metrics`` is
actually asked.

Export formats:

- ``collect(StatsCollector)`` — the classic OpenTSDB line format
  (``tsd.name timestamp value tag=v``); timers expand to
  p50/p95/p99 percentile lines plus ``.count`` / ``.sum_ms``.
- ``prometheus_text(extra_lines=...)`` — Prometheus text exposition:
  counters/gauges typed as such, timers as summaries
  (``quantile`` labels + ``_count``/``_sum``), and any classic stats
  lines passed in converted to untyped gauges (deduplicated, so the
  ``/metrics`` endpoint can merge both worlds without double
  exposition).
"""

from __future__ import annotations

import os
import re
import threading
import time

from opentsdb_tpu_torch.stats.collector import LatencyDigest, StatsCollector

_TIMER_PERCENTILES = (50, 95, 99)


class Counter:
    """Monotonic event count. ``inc`` is a plain attribute add — the
    same (GIL-serialized, occasionally-racy-by-one) discipline every
    existing stats counter in this codebase uses."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value, read at export: holds a callable."""

    __slots__ = ("fn",)

    def __init__(self, fn) -> None:
        self.fn = fn

    def read(self):
        return self.fn()


class Timer:
    """Latency distribution (ms): t-digest percentiles + count + sum."""

    __slots__ = ("digest", "total_ms")

    def __init__(self) -> None:
        self.digest = LatencyDigest()
        self.total_ms = 0.0

    def observe(self, ms: float) -> None:
        self.digest.add(ms)
        self.total_ms += ms

    @property
    def count(self) -> int:
        return self.digest.count

    def time(self) -> "_TimerCtx":
        return _TimerCtx(self)


class _TimerCtx:
    __slots__ = ("timer", "t0")

    def __init__(self, timer: Timer) -> None:
        self.timer = timer

    def __enter__(self) -> "_TimerCtx":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.timer.observe((time.perf_counter() - self.t0) * 1000.0)


def _tags_key(tags: dict | None) -> tuple:
    return tuple(sorted(tags.items())) if tags else ()


class MetricsRegistry:
    """Named instruments, get-or-create by (name, tags)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[tuple, object] = {}
        self._kinds: dict[str, str] = {}

    def _get(self, name: str, tags: dict | None, kind: str, make):
        key = (name, _tags_key(tags))
        with self._lock:
            prev = self._kinds.get(name)
            if prev is not None and prev != kind:
                # Checked on EVERY get, not just creation: counter("x")
                # after timer("x") must fail loudly, not hand back a
                # Timer to code about to call .inc() on it.
                raise ValueError(
                    f"metric {name!r} already registered as {prev}, "
                    f"not {kind}")
            obj = self._metrics.get(key)
            if obj is None:
                self._kinds[name] = kind
                obj = self._metrics[key] = make()
            return obj

    def counter(self, name: str, tags: dict | None = None) -> Counter:
        return self._get(name, tags, "counter", Counter)

    def timer(self, name: str, tags: dict | None = None) -> Timer:
        return self._get(name, tags, "timer", Timer)

    def gauge(self, name: str, fn, tags: dict | None = None) -> Gauge:
        return self._get(name, tags, "gauge", lambda: Gauge(fn))

    def names(self) -> set[str]:
        with self._lock:
            return set(self._kinds)

    def _snapshot(self) -> list[tuple[str, str, tuple, object]]:
        with self._lock:
            return [(name, self._kinds[name], tkey, obj)
                    for (name, tkey), obj in sorted(self._metrics.items())]

    # -- classic /stats line export -------------------------------------

    def collect(self, collector: StatsCollector) -> None:
        """Emit every instrument as OpenTSDB stats lines."""
        for name, kind, tkey, obj in self._snapshot():
            base = " ".join(f"{k}={v}" for k, v in tkey)
            if kind == "counter":
                collector.record(name, obj.value, base or None)
            elif kind == "gauge":
                try:
                    v = obj.read()
                except Exception:
                    continue
                collector.record(name, v, base or None)
            else:  # timer
                sep = base + " " if base else ""
                for p in _TIMER_PERCENTILES:
                    # Microsecond precision kept: wal.fsync / chunk
                    # decode percentiles are sub-millisecond, and the
                    # reference's int-ms convention would flatten them
                    # (and every self-monitored tsd.* series built
                    # from them) to a permanent 0.
                    collector.record(
                        name, round(obj.digest.percentile(p), 3),
                        f"{sep}percentile={p}")
                collector.record(name + ".count", obj.count, base or None)
                collector.record(name + ".sum_ms",
                                 round(obj.total_ms, 3), base or None)

    # -- Prometheus text exposition -------------------------------------

    @staticmethod
    def _sanitize(name: str) -> str:
        out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
        if out and out[0].isdigit():
            out = "_" + out
        return out

    @staticmethod
    def _label_str(pairs) -> str:
        if not pairs:
            return ""
        items = []
        for k, v in pairs:
            k = re.sub(r"[^a-zA-Z0-9_]", "_", str(k))
            v = (str(v).replace("\\", "\\\\").replace('"', '\\"')
                 .replace("\n", "\\n"))
            items.append(f'{k}="{v}"')
        return "{" + ",".join(items) + "}"

    @staticmethod
    def _fmt(v) -> str:
        f = float(v)
        return str(int(f)) if f.is_integer() and abs(f) < 2**53 else repr(f)

    def prometheus_text(self, extra_lines=(), prefix: str = "tsd") -> str:
        """Render the registry (typed) plus classic stats lines
        (untyped gauges) as one valid exposition: one ``# TYPE`` per
        family, type line before samples, families contiguous, no
        duplicate (name, labels) sample."""
        # family name -> (type, [(sample_suffix, labels_str, value)])
        families: dict[str, tuple[str, list]] = {}
        seen: set[tuple[str, str, str]] = set()

        def add(fam: str, ftype: str, suffix: str, labels: str, value):
            ent = families.get(fam)
            if ent is None:
                ent = families[fam] = (ftype, [])
            if ent[0] != ftype:
                return  # name/type conflict: first registration wins
            k = (fam, suffix, labels)
            if k in seen:
                return
            seen.add(k)
            ent[1].append((suffix, labels, value))

        pfx = self._sanitize(prefix) + "_" if prefix else ""
        registry_names = set()
        for name, kind, tkey, obj in self._snapshot():
            fam = pfx + self._sanitize(name)
            registry_names.add(fam)
            if kind == "counter":
                add(fam, "counter", "", self._label_str(tkey), obj.value)
            elif kind == "gauge":
                try:
                    v = obj.read()
                except Exception:
                    continue
                add(fam, "gauge", "", self._label_str(tkey), v)
            else:  # timer -> summary (milliseconds)
                fam_ms = fam + "_ms"
                registry_names.add(fam_ms)
                # collect() also spells this timer as classic
                # <name>.count / <name>.sum_ms lines; claim those
                # names too or the extra_lines merge would re-export
                # every timer as redundant untyped gauges next to the
                # summary's _count/_sum.
                registry_names.add(fam + "_count")
                registry_names.add(fam + "_sum_ms")
                for p in _TIMER_PERCENTILES:
                    labels = self._label_str(
                        list(tkey) + [("quantile", f"{p / 100:g}")])
                    add(fam_ms, "summary", "", labels,
                        obj.digest.percentile(p))
                add(fam_ms, "summary", "_count", self._label_str(tkey),
                    obj.count)
                add(fam_ms, "summary", "_sum", self._label_str(tkey),
                    obj.total_ms)

        for line in extra_lines:
            parts = line.split()
            if len(parts) < 3:
                continue
            name, _ts, value = parts[0], parts[1], parts[2]
            try:
                value = float(value)
            except ValueError:
                continue
            fam = self._sanitize(name)
            if fam in registry_names or fam + "_ms" in registry_names:
                continue  # the registry already exposes this, typed
            pairs = []
            ok = True
            for tag in parts[3:]:
                k, sep, v = tag.partition("=")
                if not sep:
                    ok = False
                    break
                pairs.append((k, v))
            if ok:
                add(fam, "gauge", "", self._label_str(sorted(pairs)),
                    value)

        out = []
        for fam in sorted(families):
            ftype, samples = families[fam]
            out.append(f"# TYPE {fam} {ftype}")
            for suffix, labels, value in samples:
                out.append(f"{fam}{suffix}{labels} {self._fmt(value)}")
        return "\n".join(out) + "\n" if out else ""


METRICS = MetricsRegistry()


def read_rss_bytes() -> int:
    """Resident set size of this process, 0 when unreadable.

    /proc gives CURRENT rss; the getrusage fallback (no procfs) is the
    lifetime PEAK — close enough for a liveness gauge, but it will not
    show post-spill drops. ru_maxrss units differ by platform: KiB on
    Linux, bytes on the BSDs/macOS."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE")
                                               if hasattr(os, "sysconf")
                                               else 4096)
    except (OSError, ValueError, IndexError):
        try:
            import resource
            import sys
            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            return peak if sys.platform == "darwin" else peak * 1024
        except Exception:
            return 0
