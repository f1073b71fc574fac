"""Wire decoding of telnet ``put`` lines and ``/api/put`` JSON bodies into
columnar batches.

Mirrors ``opentsdb_tpu/server/wire.py`` of the JAX package:
``decode_puts`` turns a buffer of ``put`` lines, and ``decode_json_puts``
a JSON datapoint object or array, into columnar arrays plus a canonical
series table (the form ``TSDB.add_batch`` consumes), and ``ingest_batch``
feeds such a batch in, series by series, charged to one tenant.
``decode_puts`` runs the native C++ decoder (the port's copy,
``native/wire_decoder.cpp``, built at first use by ``utils/nativeext.py``
and loaded with ctypes) unless the caller passes ``use_native=False`` or
a test sets ``_NATIVE`` to None; the vectorized numpy decoder is the
reference. Both accept the same lines, but the native decoder words its
errors its own way and reports no line numbers (``error_lines`` empty).
Under WAL group commit (``Config.wal_group_ms``) ``ingest_batch`` writes
each series with ``sync=False`` and runs one covering
``store.wal_barrier()`` before it returns, as the JAX package does. Left
out with its item: the ``[fenced]`` error tag (ROADMAP queue A item 10).
Both decoders run under the ``ingest.parse`` timer (``obs/registry.py``),
once per buffer or body.
"""

from __future__ import annotations

import ctypes
import re
from typing import NamedTuple

import numpy as np

from opentsdb_tpu_torch.core import tags as tags_mod
from opentsdb_tpu_torch.core.errors import FencedWriterError, TenantLimitError
from opentsdb_tpu_torch.obs.registry import METRICS as _metrics
from opentsdb_tpu_torch.utils.nativeext import WIRE as _NATIVE

_M_PARSE = _metrics.timer("ingest.parse")


class DecodedBatch(NamedTuple):
    timestamps: np.ndarray   # int64 [N]
    fvalues: np.ndarray      # float64 [N]
    ivalues: np.ndarray      # int64 [N] (exact ints where ~is_float)
    is_float: np.ndarray     # bool [N]
    sid: np.ndarray          # int32 [N] index into series
    series: list[tuple[str, dict[str, str]]]  # sid -> (metric, tags)
    errors: list[str]
    consumed: int            # bytes of complete lines consumed
    # Stream line number (0-based, offset by the caller's line_base) of
    # each entry in ``errors``. Empty when the decoder cannot attribute
    # lines (the native path), in which case callers fall back to
    # index-free error reporting.
    error_lines: tuple | list = ()



def native_available() -> bool:
    return _NATIVE is not None


def _parse_series_name(name: str) -> tuple[str, dict[str, str]]:
    parts = name.split(" ")
    tag_map: dict[str, str] = {}
    for t in parts[1:]:
        k, _, v = t.partition("=")
        tag_map[k] = v
    return parts[0], tag_map


def decode_puts(buf: bytes, use_native: bool | None = None,
                line_base: int = 0) -> DecodedBatch:
    """Decode a buffer of ``put`` lines into a columnar batch.

    ``use_native`` None or True takes the native decoder when the module
    holds one. ``line_base`` offsets the per-error line numbers of the
    numpy decoder so chunked callers (the telnet bulk path feeds one TCP
    read at a time) report exact stream line indices rather than
    batch-relative offsets.
    """
    with _M_PARSE.time():
        if use_native is None:
            use_native = _NATIVE is not None
        if use_native and _NATIVE is not None:
            return _decode_native(buf)
        return _decode_python(buf, line_base)


def _decode_native(buf: bytes) -> DecodedBatch:
    arena = _NATIVE.tsd_parse(buf, len(buf))
    try:
        n = _NATIVE.tsd_npoints(arena)
        ts = np.empty(n, np.int64)
        fv = np.empty(n, np.float64)
        iv = np.empty(n, np.int64)
        isf = np.empty(n, np.uint8)
        sid = np.empty(n, np.int32)
        if n:
            _NATIVE.tsd_copy_points(
                arena,
                ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                fv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                iv.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                isf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                sid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        series = [
            _parse_series_name(
                _NATIVE.tsd_series_name(arena, i).decode())
            for i in range(_NATIVE.tsd_nseries(arena))]
        errors = [_NATIVE.tsd_error(arena, i).decode()
                  for i in range(_NATIVE.tsd_nerrors(arena))]
        consumed = _NATIVE.tsd_consumed(arena)
    finally:
        _NATIVE.tsd_free(arena)
    return DecodedBatch(ts, fv, iv, isf.astype(bool), sid, series,
                        errors, consumed)


def _parse_scalar_line(raw: bytes, series: list, series_ids: dict):
    """Parse ONE raw telnet line with the reference per-line grammar.

    Returns ``(ts, fv, iv, isf, sid)`` (registering new series into
    ``series``/``series_ids``), ``None`` for a blank line, or raises
    ``ValueError``. This is the single source of truth for line
    semantics: the vectorized decoder routes every irregular line here,
    and ``_decode_scalar`` (the differential-test oracle) is a plain
    loop over it — so the two decoders cannot drift on the hard cases.
    """
    line = raw.decode("utf-8", "replace").rstrip("\r")
    words = tags_mod.split_string(line)
    if not words:
        return None
    if words[0] != "put":
        raise ValueError(f"unknown command: {words[0]}")
    if len(words) < 5:
        raise ValueError(f"not enough arguments: {line}")
    metric = words[1]
    tags_mod.validate_string("metric name", metric)
    try:
        ts = tags_mod.parse_long(words[2])
    except ValueError:
        raise ValueError(
            f"invalid timestamp: {words[2]}") from None
    if ts <= 0 or ts > 0xFFFFFFFF:
        raise ValueError(f"invalid timestamp: {words[2]}")
    tag_map: dict[str, str] = {}
    for t in words[4:]:
        tags_mod.parse(tag_map, t)
        k, _, v = t.partition("=")
        tags_mod.validate_string("tag name", k)
        tags_mod.validate_string("tag value", v)
    if not tag_map:
        raise ValueError("need at least one tag")
    isf, iv, fv = tags_mod.parse_value(words[3])
    canon = metric + "".join(
        f" {k}={v}" for k, v in sorted(tag_map.items()))
    sid = series_ids.get(canon)
    if sid is None:
        sid = len(series)
        series_ids[canon] = sid
        series.append((metric, tag_map))
    return ts, fv, iv, isf, sid


# Strict wire float grammar as bytes (mirror of tags._FLOAT_RE): the
# vectorized path pre-validates with this, then batch-converts via
# numpy's strtod — acceptance and rounding match the scalar parser.
_FLOAT_RE_B = re.compile(rb"[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?")


def _decode_python(buf: bytes, line_base: int = 0) -> DecodedBatch:
    """Vectorized telnet ``put`` decoder.

    One C-level pass frames and shape-checks lines; timestamps and
    values across the whole batch parse as numpy column operations
    (bytes matrices -> digit masks -> one ``astype`` cast each); metric
    validation, tag parsing, and series-id resolution run once per
    DISTINCT byte string and amortize to dict probes for repeats. Lines
    that don't fit the regular single-space shape (multi-space runs,
    ``\\r``, NULs, non-put commands) drop to ``_parse_scalar_line``,
    so error text and acceptance are identical to the scalar oracle on
    every input. Output point/series/error ordering follows line order
    exactly as the scalar decoder produces it.
    """
    consumed = buf.rfind(b"\n") + 1
    data = buf[:consumed]
    series: list[tuple[str, dict[str, str]]] = []
    series_ids: dict[str, int] = {}
    err_pairs: list[tuple[int, str]] = []   # (line_no, message)
    empty = (np.empty(0, np.int64), np.empty(0, np.float64),
             np.empty(0, np.int64), np.empty(0, bool),
             np.empty(0, np.int32))
    if not data:
        return DecodedBatch(*empty, series, [], consumed, [])

    # -- pass 1: vectorized framing and shape classification -----------
    # A line is "fast" when it is ``put metric ts value tags...`` with
    # single spaces only and no CR/NUL: field boundaries are then the
    # first three spaces after the command, all found as global
    # position-array operations — no per-line tokenizing.
    arr = np.frombuffer(data, np.uint8)
    ends = np.flatnonzero(arr == 10)
    nl = ends.size
    starts = np.empty(nl, np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lens = ends - starts
    nonblank = lens > 0
    pre = np.zeros(nl, bool)
    cand = np.flatnonzero(lens >= 4)
    if cand.size:
        head = arr[starts[cand][:, None] + np.arange(4)]
        pre[cand] = (head == np.frombuffer(b"put ", np.uint8)).all(axis=1)
    badp = np.flatnonzero((arr == 13) | (arr == 0))
    dsp = np.flatnonzero((arr[:-1] == 32) & (arr[1:] == 32))

    def _contains(pos: np.ndarray) -> np.ndarray:
        return (np.searchsorted(pos, ends) > np.searchsorted(pos, starts))

    trail_sp = np.zeros(nl, bool)
    trail_sp[nonblank] = arr[ends[nonblank] - 1] == 32
    spp = np.flatnonzero(arr == 32)
    spp_pad = np.concatenate([spp, np.full(3, arr.size, spp.dtype)])
    j = np.searchsorted(spp, starts + 4)
    p1 = spp_pad[j]
    p2 = spp_pad[j + 1]
    p3 = spp_pad[j + 2]
    # Field-width caps bound the gather matrices; an over-wide ts or
    # value field is sent to the oracle (a >18-digit ts field may still
    # be valid through leading zeros and needs parse_long's exact
    # handling — as may a >48-byte value, a legal float needing
    # parse_value's).
    fast = (pre & ~_contains(badp) & ~_contains(dsp) & ~trail_sp
            & (p3 < ends)
            & (p2 - p1 <= 19) & (p3 - p2 <= 49)
            & (arr[np.minimum(p1 + 1, arr.size - 1)] != 43))
    fr = np.flatnonzero(fast)                 # fast rows (line indices)
    sr = np.flatnonzero(nonblank & ~fast)     # oracle rows
    nf = fr.size

    # -- pass 2: columnar timestamp + value parse ----------------------
    if nf:
        fs, fe = starts[fr], ends[fr]
        fp1, fp2, fp3 = p1[fr], p2[fr], p3[fr]

        def _field(lo: np.ndarray, hi: np.ndarray):
            """Gather variable-width fields into a null-padded bytes
            matrix (rows can then view as one fixed-width S column)."""
            flen = hi - lo
            w = int(flen.max())
            gi = lo[:, None] + np.arange(w)
            return (np.where(np.arange(w) < flen[:, None],
                             arr[np.minimum(gi, arr.size - 1)], 0),
                    flen)

        m, tslen = _field(fp1 + 1, fp2)
        dig = (m >= 48) & (m <= 57)
        pad = m == 0
        # all-digit body, padding only as a suffix. Pass 1 capped the
        # field at 18 digits, so the int64 cast below is always exact
        # (leading zeros may hide a small valid ts inside a wide
        # field); the range check right after decides validity.
        ts_ok = ((dig | pad).all(axis=1) & dig[:, 0]
                 & ~(pad[:, :-1] & dig[:, 1:]).any(axis=1))
        ts_vals = np.zeros(nf, np.int64)
        sel = np.flatnonzero(ts_ok)
        if sel.size:
            tsa = np.ascontiguousarray(m).view(f"S{m.shape[1]}").ravel()
            ts_vals[sel] = tsa[sel].astype(np.int64)
        ts_ok &= (ts_vals > 0) & (ts_vals <= 0xFFFFFFFF)

        vm, vlen = _field(fp2 + 1, fp3)
        va = np.ascontiguousarray(vm).view(f"S{vm.shape[1]}").ravel()
        vdig = (vm >= 48) & (vm <= 57)
        vpad = vm == 0
        sign = (vm[:, 0] == 43) | (vm[:, 0] == 45)
        ndig = vdig.sum(axis=1)
        # int syntax = optional sign then >= 1 digit (parse_long's
        # grammar); cap at 18 digits so the int64 cast can't overflow —
        # longer ints take parse_value for its exact overflow message.
        int_syntax = ((vdig[:, 0] | sign)
                      & (vdig | vpad)[:, 1:].all(axis=1)
                      & ~(vpad[:, :-1] & vdig[:, 1:]).any(axis=1)
                      & (ndig >= 1))
        int_like = int_syntax & (ndig <= 18)
        isf_arr = np.zeros(nf, bool)
        iv_arr = np.zeros(nf, np.int64)
        fv_arr = np.zeros(nf, np.float64)
        val_ok = np.ones(nf, bool)
        val_err: dict[int, str] = {}
        sel = np.flatnonzero(int_like)
        if sel.size:
            ivs = va[sel].astype(np.int64)
            iv_arr[sel] = ivs
            fv_arr[sel] = ivs.astype(np.float64)
        # unsigned digits.digits — the common float shape — converts
        # as one batch cast; anything fancier (signs, exponents, "5.")
        # revalidates against the strict grammar regex per value.
        isdot = vm == 46
        last = vm[np.arange(nf), vlen - 1]
        simple_f = (~int_syntax & (isdot.sum(axis=1) == 1)
                    & (vdig | isdot | vpad).all(axis=1)
                    & ~(vpad[:, :-1] & ~vpad[:, 1:]).any(axis=1)
                    & vdig[:, 0] & (last >= 48) & (last <= 57))
        sel = np.flatnonzero(simple_f)
        if sel.size:
            isf_arr[sel] = True
            fv_arr[sel] = va[sel].astype(np.float64)
        hard = np.flatnonzero(~int_like & ~simple_f)
        if hard.size:
            fp2_l, fp3_l = fp2.tolist(), fp3.tolist()
            int_syn_l = int_syntax.tolist()
            flt = np.array([
                not int_syn_l[k] and _FLOAT_RE_B.fullmatch(
                    data[fp2_l[k] + 1:fp3_l[k]]) is not None
                for k in hard.tolist()], bool)
            good = hard[flt]
            if good.size:
                isf_arr[good] = True
                fv_arr[good] = va[good].astype(np.float64)
            for k in hard[~flt].tolist():
                try:
                    isf, iv, fv = tags_mod.parse_value(
                        data[fp2_l[k] + 1:fp3_l[k]].decode(
                            "utf-8", "replace"))
                    isf_arr[k] = isf
                    iv_arr[k] = iv
                    fv_arr[k] = fv
                except ValueError as e:
                    val_ok[k] = False
                    val_err[k] = str(e)
        ts_ok_l = ts_ok.tolist()
        val_ok_l = val_ok.tolist()

    # -- pass 3: per-line resolution in stream order -------------------
    # Per fast line: two slices + dict probes. Metric validation, tag
    # parse/validate, and canonicalization run once per distinct byte
    # string; a (metric, tags) pair maps straight to its sid afterward.
    # Fast and oracle rows interleave in line order so series-id
    # assignment (first fully-valid appearance wins) matches the
    # oracle's numbering exactly.
    metric_cache: dict[bytes, object] = {}   # -> str | ValueError
    tags_cache: dict[bytes, object] = {}     # -> dict | ValueError
    pair_sid: dict[tuple, int] = {}
    keep_fi: list[int] = []   # fast indices emitted, in line order
    keep_sid: list[int] = []
    slow_pts: list = []       # (line_no, ts, fv, iv, isf, sid)
    if nf:
        fs_l, fe_l = fs.tolist(), fe.tolist()
        fp1_l, fp3_l = fp1.tolist(), fp3.tolist()
        fr_l = fr.tolist()
    if sr.size:
        sl = starts[sr].tolist()
        se = ends[sr].tolist()
        sr_l = sr.tolist()
        walk = sorted(
            [(ln, fi, -1) for fi, ln in enumerate(fr_l)]
            + [(ln, -1, si) for si, ln in enumerate(sr_l)]) if nf else [
            (ln, -1, si) for si, ln in enumerate(sr_l)]
    else:
        walk = [(ln, fi, -1) for fi, ln in enumerate(fr_l)] if nf else []
    for i, fi, si in walk:
        if fi < 0:
            try:
                pt = _parse_scalar_line(data[sl[si]:se[si]],
                                        series, series_ids)
            except ValueError as e:
                err_pairs.append((i, str(e)))
                continue
            if pt is not None:
                slow_pts.append((i, *pt))
            continue
        mkey = data[fs_l[fi] + 4:fp1_l[fi]]
        tkey = data[fp3_l[fi] + 1:fe_l[fi]]
        sid = pair_sid.get((mkey, tkey), -1)
        if sid < 0:
            # Error precedence matches the oracle: metric, timestamp,
            # tags, value — only then does the series register (an
            # all-error series never claims a sid).
            mres = metric_cache.get(mkey)
            if mres is None:
                metric = mkey.decode("utf-8", "replace")
                try:
                    tags_mod.validate_string("metric name", metric)
                    mres = metric
                except ValueError as e:
                    mres = e
                metric_cache[mkey] = mres
            if type(mres) is not str:
                err_pairs.append((i, str(mres)))
                continue
            if not ts_ok_l[fi]:
                err_pairs.append((i, "invalid timestamp: " + data[
                    fp1_l[fi] + 1:fp1_l[fi] + 1 + int(tslen[fi])].decode(
                        "utf-8", "replace")))
                continue
            tres = tags_cache.get(tkey)
            if tres is None:
                tag_map: dict[str, str] = {}
                try:
                    for t in tkey.decode("utf-8", "replace").split(" "):
                        tags_mod.parse(tag_map, t)
                        k, _, v = t.partition("=")
                        tags_mod.validate_string("tag name", k)
                        tags_mod.validate_string("tag value", v)
                    tres = tag_map
                except ValueError as e:
                    tres = e
                tags_cache[tkey] = tres
            if type(tres) is not dict:
                err_pairs.append((i, str(tres)))
                continue
            if not val_ok_l[fi]:
                err_pairs.append((i, val_err[fi]))
                continue
            canon = mres + "".join(
                f" {k}={v}" for k, v in sorted(tres.items()))
            sid = series_ids.get(canon)
            if sid is None:
                sid = len(series)
                series_ids[canon] = sid
                series.append((mres, dict(tres)))
            pair_sid[(mkey, tkey)] = sid
        else:
            if not ts_ok_l[fi]:
                err_pairs.append((i, "invalid timestamp: " + data[
                    fp1_l[fi] + 1:fp1_l[fi] + 1 + int(tslen[fi])].decode(
                        "utf-8", "replace")))
                continue
            if not val_ok_l[fi]:
                err_pairs.append((i, val_err[fi]))
                continue
        keep_fi.append(fi)
        keep_sid.append(sid)

    errors = [msg for _, msg in err_pairs]
    error_lines = [line_base + ln for ln, _ in err_pairs]
    # -- assembly: columnar gather, slow lines merged by line order ----
    if not keep_fi and not slow_pts:
        return DecodedBatch(*empty, series, errors, consumed, error_lines)
    if keep_fi:
        kfi = np.asarray(keep_fi, np.int64)
        f_cols = (ts_vals[kfi], fv_arr[kfi], iv_arr[kfi], isf_arr[kfi],
                  np.asarray(keep_sid, np.int32))
    if not slow_pts:
        cols = f_cols
    else:
        s_lines = np.asarray([p[0] for p in slow_pts], np.int64)
        s_cols = (np.asarray([p[1] for p in slow_pts], np.int64),
                  np.asarray([p[2] for p in slow_pts], np.float64),
                  np.asarray([p[3] for p in slow_pts], np.int64),
                  np.asarray([p[4] for p in slow_pts], bool),
                  np.asarray([p[5] for p in slow_pts], np.int32))
        if not keep_fi:
            cols = s_cols
        else:
            f_lines = fr[kfi]
            order = np.argsort(np.concatenate([f_lines, s_lines]),
                               kind="stable")
            cols = tuple(np.concatenate([f, s])[order]
                         for f, s in zip(f_cols, s_cols))
    return DecodedBatch(*cols, series, errors, consumed, error_lines)


def decode_json_puts(obj) -> DecodedBatch:
    """Decode an ``/api/put`` JSON body (one object or an array of
    ``{"metric", "timestamp", "value", "tags"}``) into the same
    columnar batch the telnet decoder produces.

    Per-point Python work is two dict probes and a list append; series
    validation/canonicalization runs once per distinct (metric, tags)
    and timestamps/values convert as whole-column numpy casts when the
    batch is homogeneous (all-int or all-float values — the shape
    collectors send), falling back per point only for mixed or string
    typed entries. ``error_lines`` carries the failing point's array
    index.
    """
    with _M_PARSE.time():
        return _decode_json_puts(obj)


def _decode_json_puts(obj) -> DecodedBatch:
    if isinstance(obj, dict):
        obj = [obj]
    if not isinstance(obj, list):
        raise ValueError(
            "expected a JSON datapoint object or array of them")
    n = len(obj)
    series: list[tuple[str, dict[str, str]]] = []
    series_ids: dict[str, int] = {}
    pair_cache: dict = {}        # (metric, tags items) -> sid | error
    errors: list[str] = []
    error_lines: list[int] = []
    sid = np.full(n, -1, np.int32)
    ts_raw: list = [None] * n
    val_raw: list = [None] * n
    for i, d in enumerate(obj):
        if not isinstance(d, dict):
            errors.append(f"datapoint {i} is not an object")
            error_lines.append(i)
            continue
        metric = d.get("metric")
        tags = d.get("tags")
        try:
            key = (metric, tuple(sorted(tags.items()))
                   if isinstance(tags, dict) else None)
        except TypeError:
            errors.append(f"unsortable tags in datapoint {i}")
            error_lines.append(i)
            continue
        s = pair_cache.get(key)
        if s is None:
            try:
                if not isinstance(metric, str):
                    raise ValueError("missing or non-string metric")
                if not isinstance(tags, dict):
                    raise ValueError("missing tags object")
                tag_map = {str(k): str(v) for k, v in tags.items()}
                tags_mod.check_metric_and_tags(metric, tag_map)
                canon = metric + "".join(
                    f" {k}={v}" for k, v in sorted(tag_map.items()))
                s = series_ids.get(canon)
                if s is None:
                    s = len(series)
                    series_ids[canon] = s
                    series.append((metric, tag_map))
            except ValueError as e:
                s = e
            pair_cache[key] = s
        if type(s) is not int:
            errors.append(str(s))
            error_lines.append(i)
            continue
        sid[i] = s
        ts_raw[i] = d.get("timestamp")
        val_raw[i] = d.get("value")

    ok = sid >= 0
    rows = np.flatnonzero(ok)
    ts_vals = np.zeros(n, np.int64)
    fv = np.zeros(n, np.float64)
    iv = np.zeros(n, np.int64)
    isf = np.zeros(n, bool)

    def _scalar_ts(x):
        if isinstance(x, bool):
            raise ValueError
        if isinstance(x, str):
            x = tags_mod.parse_long(x)
        if isinstance(x, float):
            if x != int(x):
                raise ValueError
            x = int(x)
        if not isinstance(x, int):
            raise ValueError
        return x

    if rows.size:
        col = [ts_raw[k] for k in rows.tolist()]
        arr = None
        if set(map(type, col)) == {int}:
            try:
                arr = np.asarray(col, np.int64)
            except OverflowError:
                arr = None
        if arr is not None:
            ts_vals[rows] = arr
        else:
            for k, x in zip(rows.tolist(), col):
                try:
                    ts_vals[k] = _scalar_ts(x)
                except (ValueError, TypeError, OverflowError):
                    ok[k] = False
                    errors.append(f"invalid timestamp: {x}")
                    error_lines.append(k)
        bad = rows[(ts_vals[rows] <= 0)
                   | (ts_vals[rows] > 0xFFFFFFFF)]
        for k in bad.tolist():
            if ok[k]:
                ok[k] = False
                errors.append(f"invalid timestamp: {ts_raw[k]}")
                error_lines.append(k)

    rows = np.flatnonzero(ok)
    if rows.size:
        col = [val_raw[k] for k in rows.tolist()]
        # type-set probe (one C-speed map) keeps int/float typing
        # exact: np.asarray on a mixed list would silently promote
        # every int to float64 and change how points are encoded.
        tset = set(map(type, col))
        arr = None
        if tset == {int}:
            try:
                arr = np.asarray(col, np.int64)
            except OverflowError:
                arr = None
            if arr is not None:
                iv[rows] = arr
                fv[rows] = arr.astype(np.float64)
        elif tset == {float}:
            arr = np.asarray(col, np.float64)
            fv[rows] = arr
            isf[rows] = True
        if arr is None:
            for k, x in zip(rows.tolist(), col):
                try:
                    if isinstance(x, bool):
                        raise ValueError(f"invalid value: {x}")
                    if isinstance(x, str):
                        f, i2, f2 = tags_mod.parse_value(x)
                        isf[k], iv[k], fv[k] = f, i2, f2
                    elif isinstance(x, int):
                        iv[k] = x
                        fv[k] = float(x)
                    elif isinstance(x, float):
                        fv[k] = x
                        isf[k] = True
                    else:
                        raise ValueError(f"invalid value: {x}")
                except (ValueError, TypeError, OverflowError):
                    ok[k] = False
                    errors.append(f"invalid value: {x}")
                    error_lines.append(k)

    rows = np.flatnonzero(ok)
    # sort point-index-attributed errors back into point order (the
    # ts/value passes appended out of order relative to series errors)
    pairs = sorted(zip(error_lines, errors))
    return DecodedBatch(
        ts_vals[rows], fv[rows], iv[rows], isf[rows], sid[rows],
        series, [m for _, m in pairs], 0, [ln for ln, _ in pairs])


def ingest_batch(tsdb, batch: DecodedBatch, durable: bool = True,
                 tenant: str = "default") -> tuple[int, list[str]]:
    """Feed a decoded batch into the TSDB via the columnar write path,
    charged to ``tenant``.

    Series are ingested independently: one series failing (unknown
    metric, conflicting duplicate, tenant limit) does not drop the
    others — matching the per-line put semantics. Returns
    (points_written, per-series error strings); a tenant-limit refusal
    carries the stable ``[tenant-limit] `` tag and a deposed writer's
    refusal the ``[fenced] `` tag the server's classifier
    keys on. One argsort groups points by series; no per-series
    full-array masks.
    """
    n = 0
    errors: list[str] = []
    if len(batch.sid) == 0:
        return 0, errors
    order = np.argsort(batch.sid, kind="stable")
    sid_sorted = batch.sid[order]
    starts = np.concatenate(
        ([0], np.flatnonzero(np.diff(sid_sorted)) + 1, [len(order)]))
    # Under WAL group commit each series' put skips its own wait
    # (sync=False) and one covering barrier runs before this returns: the
    # batch waits for one flush instead of one per series, and the
    # caller's acknowledgement still follows it. The finally keeps that
    # when a put raises mid-batch.
    try:
        for i in range(len(starts) - 1):
            run = order[starts[i]:starts[i + 1]]
            s = int(sid_sorted[starts[i]])
            metric, tag_map = batch.series[s]
            try:
                n += tsdb.add_batch(
                    metric, batch.timestamps[run], batch.fvalues[run],
                    tag_map, durable=durable,
                    is_float=batch.is_float[run],
                    int_values=batch.ivalues[run], tenant=tenant,
                    sync=False)
            except Exception as e:
                # A tenant-limit refusal is per-series: the tenant's
                # EXISTING series in this batch still ingest; only the new
                # one refuses. The server's classifier keys on the stable
                # tags, not on the exception's wording.
                if isinstance(e, FencedWriterError):
                    tag = "[fenced] "
                elif isinstance(e, TenantLimitError):
                    tag = "[tenant-limit] "
                else:
                    tag = ""
                errors.append(f"{metric}: {tag}{e}")
    finally:
        barrier = getattr(tsdb.store, "wal_barrier", None)
        if barrier is not None:
            barrier()
    return n, errors
