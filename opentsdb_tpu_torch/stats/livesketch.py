"""Device-resident streaming sketch state, folded in at ingest.

Mirrors ``opentsdb_tpu/stats/livesketch.py`` of the JAX package:

- one t-digest per series (value distribution -> p50/p95/p99 without a
  storage rescan),
- one HyperLogLog register bank per (metric, tag key) pair (distinct tag
  values, e.g. "how many hosts report sys.cpu.user").

All digests live in two [C, K] float32 tensors (means, weights), all HLLs
in one [C, 2^p] int32 tensor, on the TSDB's device; C doubles on demand
(``_pad``), exactly as the JAX stacks grow, so a snapshot either package
writes has the same arrays. ``observe()`` appends to host buffers; a full
buffer hands off to a background folder thread (a bounded queue, so a
device that cannot keep up backpressures ingest); queries drain the folder
first, so answers are exact as of the query. The fold keeps the JAX
package's chunking (``_MAX_CHUNK`` values per series a round,
``_MAX_FOLD_CELLS`` cells a call, bucketed by padded length), so the
sequence of compressions, and with it every digest, is the JAX package's.

The folds, the estimate and the merged quantile run on the kernels of
``ops/sketches.py`` (``csrc/sketches.cu`` on a card). The stacks are
updated in place where the JAX package replaced its arrays; readers hold
the locks that keep folds out.

``save``/``load`` write and read the JAX package's ``.npz`` snapshot (the
same keys, shapes and dtypes), so either package loads the other's.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading

import numpy as np
import torch

from opentsdb_tpu_torch.core.const import UID_WIDTH
from opentsdb_tpu_torch.ops import sketches
from opentsdb_tpu_torch.utils.config import resolve_device

_PAD_MIN = 8


def _pad(n: int) -> int:
    size = _PAD_MIN
    while size < n:
        size *= 2
    return size


class LiveSketches:
    """Streaming sketch store; thread-safe (one lock around buffer+state).

    ``compression``: t-digest centroid budget per series (K).
    ``hll_p``: per-(metric, tagk) register count exponent (2^p int32).
    ``flush_points``: buffered-point bound before an automatic fold.
    ``device``: where the stacks live and the folds run; the card unless
    the caller asks for the CPU.
    """

    # Fold-batch bounds: chunk long series to _MAX_CHUNK values and cap a
    # fold call at _MAX_FOLD_CELLS dense cells (the JAX package's).
    _MAX_CHUNK = 4096
    _MAX_FOLD_CELLS = 1 << 22

    def __init__(self, compression: int = 128, hll_p: int = 12,
                 flush_points: int = 65536, background: bool = True,
                 device: str | torch.device = "cuda") -> None:
        self.compression = compression
        self.hll_p = hll_p
        self.flush_points = flush_points
        self.background = background
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._lock = threading.RLock()
        # Guards the device stacks: the folder thread updates them while
        # observers (holding only self._lock) keep buffering.
        self._state_lock = threading.RLock()
        self._td_slots: dict[bytes, int] = {}
        self._hll_slots: dict[tuple[bytes, bytes], int] = {}
        # Per-metric series directory (keys grouped by their metric UID).
        self._metric_series: dict[bytes, list[bytes]] = {}
        self._td_means = self._zeros((_PAD_MIN, compression), torch.float32)
        self._td_weights = self._zeros((_PAD_MIN, compression),
                                       torch.float32)
        self._hll_regs = self._zeros((_PAD_MIN, 1 << hll_p), torch.int32)
        self._td_buf: dict[int, list[np.ndarray]] = {}
        self._hll_buf: dict[int, set[int]] = {}
        self._buffered = 0
        self._pending: queue.Queue = queue.Queue(maxsize=2)
        self._folder: threading.Thread | None = None
        self._fold_error: BaseException | None = None
        # Hand-offs queued and fold calls made (the smoke's counters).
        self.hand_offs = 0
        self.fold_calls = 0

    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    # -- slot management (host-only; capacity grows at fold time) ----------

    def _td_slot(self, series_key: bytes) -> int:
        slot = self._td_slots.get(series_key)
        if slot is None:
            slot = len(self._td_slots)
            self._td_slots[series_key] = slot
            self._metric_series.setdefault(
                series_key[:UID_WIDTH], []).append(series_key)
        return slot

    def _hll_slot(self, metric_uid: bytes, tagk_uid: bytes) -> int:
        key = (metric_uid, tagk_uid)
        slot = self._hll_slots.get(key)
        if slot is None:
            slot = len(self._hll_slots)
            self._hll_slots[key] = slot
        return slot

    def _ensure_capacity(self, td_rows: int, hll_rows: int) -> None:
        """Grow the device stacks to hold the given slot counts; caller
        holds _state_lock."""
        if td_rows > self._td_means.shape[0]:
            pad = self._zeros((_pad(td_rows) - self._td_means.shape[0],
                               self.compression), torch.float32)
            self._td_means = torch.cat([self._td_means, pad])
            self._td_weights = torch.cat([self._td_weights, pad])
        if hll_rows > self._hll_regs.shape[0]:
            self._hll_regs = torch.cat([self._hll_regs, self._zeros(
                (_pad(hll_rows) - self._hll_regs.shape[0],
                 1 << self.hll_p), torch.int32)])

    # -- ingest-side API ---------------------------------------------------

    def note_series(self, series_key: bytes) -> None:
        """Register a series in the slot directory without folding any
        values (the write path calls this before the storage put, so the
        directory is a superset of the series with stored data)."""
        with self._lock:
            self._td_slot(series_key)

    def metric_series_count(self, metric_uid: bytes) -> int:
        with self._lock:
            return len(self._metric_series.get(metric_uid, ()))

    def metric_series_keys(self, metric_uid: bytes) -> list[bytes]:
        with self._lock:
            return list(self._metric_series.get(metric_uid, ()))

    def observe(self, series_key: bytes, values: np.ndarray,
                tag_uids: list[tuple[bytes, bytes, bytes]]) -> None:
        """Record one series batch: ``values`` fold into the series
        digest; each (metric_uid, tagk_uid, tagv_uid) folds the tag value
        into the pair's HLL. Host work only; the fold is deferred."""
        with self._lock:
            if len(values):
                self._td_buf.setdefault(
                    self._td_slot(series_key), []).append(
                        np.asarray(values, np.float32))
                self._buffered += len(values)
            for metric_uid, tagk_uid, tagv_uid in tag_uids:
                slot = self._hll_slot(metric_uid, tagk_uid)
                self._hll_buf.setdefault(slot, set()).add(
                    int.from_bytes(tagv_uid, "big"))
            if self._buffered >= self.flush_points:
                self._hand_off_locked()

    def _hand_off_locked(self) -> None:
        """Swap the buffers out and queue them for the folder thread (or
        fold inline when background=False). Caller holds _lock."""
        if not self._td_buf and not self._hll_buf:
            return
        td_buf, self._td_buf = self._td_buf, {}
        hll_buf, self._hll_buf = self._hll_buf, {}
        self._buffered = 0
        self.hand_offs += 1
        if not self.background:
            self._fold_buffers(td_buf, hll_buf)
            return
        if self._folder is None:
            self._folder = threading.Thread(
                target=self._fold_loop, daemon=True, name="sketch-folder")
            self._folder.start()
        self._pending.put((td_buf, hll_buf))

    def _fold_loop(self) -> None:
        # The thread's current CUDA device is not the caller's: launch on
        # the stacks' own device.
        guard = (torch.cuda.device(self.device)
                 if self.device.type == "cuda" else contextlib.nullcontext())
        while True:
            td_buf, hll_buf = self._pending.get()
            try:
                with guard:
                    self._fold_buffers(td_buf, hll_buf)
            except BaseException as e:  # surfaced on the next flush()
                self._fold_error = e
            finally:
                self._pending.task_done()

    def flush(self) -> None:
        """Fold every buffered observation and wait for the folder to
        drain; a fold's error is raised here."""
        with self._lock:
            self._hand_off_locked()
        self._pending.join()
        if self._fold_error is not None:
            err, self._fold_error = self._fold_error, None
            raise err

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _fold_td_group(self, group: list[tuple[int, np.ndarray]],
                       P: int) -> None:
        S = _pad(len(group))
        batch = np.zeros((S, P), np.float32)
        valid = np.zeros((S, P), bool)
        # Padded rows index one past the stack and are skipped.
        idx = np.full(S, self._td_means.shape[0], np.int32)
        for r, (s, v) in enumerate(group):
            batch[r, :len(v)] = v
            valid[r, :len(v)] = True
            idx[r] = s
        sketches.tdigest_fold(self._td_means, self._td_weights,
                              self._upload(idx), self._upload(batch),
                              valid=self._upload(valid),
                              compression=self.compression)
        self.fold_calls += 1

    def _fold_buffers(self, td_buf: dict, hll_buf: dict) -> None:
        """Fold one swapped-out buffer pair into the device stacks: the
        JAX package's rounds (at most one chunk per slot a round), buckets
        (by padded chunk length) and call sizes. Serialized by
        _state_lock."""
        with self._state_lock:
            if td_buf:
                self._ensure_capacity(max(td_buf) + 1, 0)
                queues: dict[int, list[np.ndarray]] = {}
                for s, chunks in td_buf.items():
                    v = np.concatenate(chunks)
                    queues[s] = [v[off:off + self._MAX_CHUNK]
                                 for off in range(0, len(v),
                                                  self._MAX_CHUNK)]
                while queues:
                    by_p: dict[int, list] = {}
                    for s in sorted(queues):
                        v = queues[s].pop(0)
                        by_p.setdefault(_pad(len(v)), []).append((s, v))
                    queues = {s: q for s, q in queues.items() if q}
                    for P, plist in sorted(by_p.items()):
                        rows = max(self._MAX_FOLD_CELLS // P, 1)
                        for i in range(0, len(plist), rows):
                            self._fold_td_group(plist[i:i + rows], P)
            if hll_buf:
                self._ensure_capacity(0, max(hll_buf) + 1)
                slots = sorted(hll_buf)
                uids = [np.fromiter(hll_buf[s], np.int32) for s in slots]
                H = _pad(len(slots))
                U = _pad(max(len(u) for u in uids))
                items = np.zeros((H, U), np.int32)
                valid = np.zeros((H, U), bool)
                for i, u in enumerate(uids):
                    items[i, :len(u)] = u
                    valid[i, :len(u)] = True
                idx = np.full(H, self._hll_regs.shape[0], np.int32)
                idx[:len(slots)] = slots
                sketches.hll_fold(self._hll_regs, self._upload(idx),
                                  self._upload(items), self._upload(valid),
                                  p=self.hll_p)
                self.fold_calls += 1

    # -- query-side API ----------------------------------------------------

    def distinct(self, metric_uid: bytes, tagk_uid: bytes) -> int | None:
        """Streaming distinct-tagv estimate; None when the pair was never
        ingested. Flushes first, so the answer is current."""
        with self._lock:
            slot = self._hll_slots.get((metric_uid, tagk_uid))
            if slot is None:
                return None
            self.flush()
            if slot >= self._hll_regs.shape[0]:
                return 0  # slot assigned but never folded
            est = sketches.hll_estimate(self._hll_regs[slot:slot + 1])
            return int(round(float(est[0])))

    def quantile(self, series_keys: list[bytes], q) -> np.ndarray | None:
        """Quantiles of the merged all-time distribution of the given
        series; None when no listed series has sketch state. ``q`` scalar
        or [Q]; returns [Q] float32."""
        with self._lock:
            slots = [self._td_slots[k] for k in series_keys
                     if k in self._td_slots]
            if not slots:
                return None
            self.flush()
            with self._state_lock:
                self._ensure_capacity(max(slots) + 1, 0)
            S = _pad(len(slots))
            idx = np.zeros(S, np.int32)
            idx[:len(slots)] = slots
            valid = np.zeros(S, bool)
            valid[:len(slots)] = True
            qs = np.atleast_1d(np.asarray(q, np.float32))
            out = sketches.merged_quantile(
                self._td_means, self._td_weights, self._upload(idx),
                self._upload(valid), self._upload(qs),
                compression=self.compression)
            return out.cpu().numpy()

    def series_count(self) -> int:
        return len(self._td_slots)

    def series_keys(self) -> list[bytes]:
        """All series with sketch state (the slot map doubles as a series
        directory)."""
        with self._lock:
            return list(self._td_slots)

    def state_bytes(self) -> int:
        """Device bytes of the three stacks."""
        return sum(t.numel() * t.element_size()
                   for t in (self._td_means, self._td_weights,
                             self._hll_regs))

    # -- merge / checkpoint ------------------------------------------------

    def merge_from(self, other: "LiveSketches") -> None:
        """Fold another store's state in: digest rows recompressed with
        the incoming rows (one fold, the incoming row as the batch), HLL
        registers by elementwise max."""
        with self._lock, other._lock:
            other.flush()
            self.flush()
            for key in other._td_slots:
                self._td_slot(key)
            for key in other._hll_slots:
                self._hll_slot(*key)
            with self._state_lock:
                self._ensure_capacity(len(self._td_slots),
                                      len(self._hll_slots))
            with other._state_lock:
                other._ensure_capacity(len(other._td_slots),
                                       len(other._hll_slots))
            if other._td_slots:
                pairs = [(self._td_slots[k], o)
                         for k, o in other._td_slots.items()]
                mine = self._upload(np.array([a for a, _ in pairs],
                                             np.int32))
                theirs = torch.tensor([b for _, b in pairs],
                                      device=other.device)
                sketches.tdigest_fold(
                    self._td_means, self._td_weights, mine,
                    other._td_means[theirs].to(self.device),
                    batch_weights=other._td_weights[theirs].to(self.device),
                    compression=self.compression)
            if other._hll_slots:
                pairs = [(self._hll_slots[k], o)
                         for k, o in other._hll_slots.items()]
                mine = torch.tensor([a for a, _ in pairs],
                                    device=self.device)
                theirs = torch.tensor([b for _, b in pairs],
                                      device=other.device)
                self._hll_regs[mine] = sketches.hll_merge(
                    self._hll_regs[mine],
                    other._hll_regs[theirs].to(self.device))

    def save(self, path: str) -> None:
        """Snapshot the state to a host .npz (atomic via tmp+rename), in
        the JAX package's layout."""
        with self._lock:
            self.flush()
            with self._state_lock:
                self._ensure_capacity(len(self._td_slots),
                                      len(self._hll_slots))
            td_keys = sorted(self._td_slots, key=self._td_slots.get)
            hll_keys = sorted(self._hll_slots, key=self._hll_slots.get)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(
                    f,
                    td_keys=np.array(td_keys, dtype=object),
                    hll_metric=np.array([k[0] for k in hll_keys],
                                        dtype=object),
                    hll_tagk=np.array([k[1] for k in hll_keys],
                                      dtype=object),
                    td_means=self._td_means.cpu().numpy(),
                    td_weights=self._td_weights.cpu().numpy(),
                    hll_regs=self._hll_regs.cpu().numpy(),
                    meta=np.array([self.compression, self.hll_p]))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, flush_points: int = 65536,
             device: str | torch.device = "cuda") -> "LiveSketches":
        z = np.load(path, allow_pickle=True)
        compression, hll_p = (int(x) for x in z["meta"])
        self = cls(compression=compression, hll_p=hll_p,
                   flush_points=flush_points, device=device)
        self._td_means = self._upload(np.ascontiguousarray(z["td_means"]))
        self._td_weights = self._upload(
            np.ascontiguousarray(z["td_weights"]))
        self._hll_regs = self._upload(np.ascontiguousarray(z["hll_regs"]))
        self._td_slots = {bytes(k): i for i, k in enumerate(z["td_keys"])}
        for k in self._td_slots:
            self._metric_series.setdefault(k[:UID_WIDTH], []).append(k)
        self._hll_slots = {
            (bytes(m), bytes(t)): i
            for i, (m, t) in enumerate(zip(z["hll_metric"], z["hll_tagk"]))}
        return self
