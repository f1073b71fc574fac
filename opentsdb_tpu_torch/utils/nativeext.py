"""Build and load the port's native ingest extension and telnet decoder.

Mirrors ``opentsdb_tpu/utils/nativeext.py`` of the JAX package, but builds
the port's own copies of the sources, ``opentsdb_tpu_torch/native/``:

- ``ingest_ext.c``, the CPython module ``tsd_ingest_ext_torch`` (the
  memtable upsert, the WAL-replay and sstable-footer slicers, the sstable
  framer, the encode buffers' cell slicer), compiled with ``gcc`` against
  ``Python.h`` and imported by path;
- ``wire_decoder.cpp``, the telnet ``put`` decoder with a plain C
  interface, compiled with ``g++`` and loaded with ctypes.

Both build with the flags of the JAX package's ``native/Makefile`` into
``_build/`` inside the package (listed in ``.gitignore``), each library
named by a hash of its source, compiler, flags and the interpreter's
``EXT_SUFFIX``, so an edited source is rebuilt and a stale library is never
loaded. A build writes a temporary file and renames it, so processes that
race on a fresh checkout each end with a whole library. Nothing is built at
import: the first call builds. A failed build or load raises
``RuntimeError`` with the compiler's log; there is no quiet fallback.

The call sites hold module handles (``EXT`` and ``WIRE`` below, imported
as ``_EXT`` / ``_NATIVE``); a test that wants the Python reference path
sets its module's handle to None. Every call through a handle adds one to
``calls[<function>]``.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build")

# The compilers; a test points one at a missing path to see a build fail.
CC = "gcc"
CXX = "g++"
CFLAGS = ("-O3", "-fPIC", "-Wall", "-Wextra", "-march=native")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
            "-march=native")

INGEST_MODULE = "tsd_ingest_ext_torch"

# Seconds each library took to build in this process (0.0 when it was
# already built), for the smoke's report.
build_seconds: dict[str, float] = {}

# Calls per C function, counted by the handles below.
SITES = ("upsert_cells", "rows_update_new", "slice_keys", "slice_varlen",
         "frame_rows", "frame_rows_dict", "slice_cells", "tsd_parse")
calls: dict[str, int] = dict.fromkeys(SITES, 0)

_lock = threading.Lock()
_loaded: dict[str, object] = {}


def reset_calls() -> None:
    for k in calls:
        calls[k] = 0


def _job(name: str) -> tuple[str, tuple[str, ...], str]:
    """(source, command without its output, library path) of ``name``."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    if name == "ingest":
        src = os.path.join(NATIVE_DIR, "ingest_ext.c")
        cmd = (CC, *CFLAGS, "-I" + sysconfig.get_paths()["include"],
               "-shared")
        stem, ext = INGEST_MODULE, suffix
    elif name == "wire":
        src = os.path.join(NATIVE_DIR, "wire_decoder.cpp")
        cmd = (CXX, *CXXFLAGS, "-shared")
        stem, ext = "libtsdwire_torch", ".so"
    else:
        raise ValueError(f"unknown native library {name!r}")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(repr((cmd, suffix)).encode())
    return src, cmd, os.path.join(
        BUILD_DIR, f"{stem}-{h.hexdigest()[:12]}{ext}")


def build(name: str) -> str:
    """Build library ``name`` ("ingest" or "wire") unless it is built;
    returns its path."""
    src, cmd, out = _job(name)
    if os.path.exists(out):
        build_seconds.setdefault(name, 0.0)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([*cmd, "-o", tmp, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, timeout=600)
    except OSError as e:
        raise RuntimeError(
            f"cannot run {cmd[0]!r} to build {os.path.basename(src)}: "
            f"{e}") from e
    log = proc.stdout.decode(errors="replace")
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise RuntimeError(
            f"{cmd[0]} failed for {os.path.basename(src)} "
            f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    return out


def build_all() -> None:
    """Build both libraries, the two compilers started together."""
    errs: dict[str, RuntimeError] = {}

    def run(name: str) -> None:
        try:
            build(name)
        except RuntimeError as e:
            errs[name] = e

    threads = [threading.Thread(target=run, args=(n,))
               for n in ("ingest", "wire")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise next(iter(errs.values()))


def ingest_module():
    """The loaded ``tsd_ingest_ext_torch`` module, built on first use."""
    mod = _loaded.get("ingest")
    if mod is not None:
        return mod
    with _lock:
        mod = _loaded.get("ingest")
        if mod is None:
            path = build("ingest")
            try:
                spec = importlib.util.spec_from_file_location(
                    INGEST_MODULE, path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
            except Exception as e:
                raise RuntimeError(
                    f"cannot load the native ingest extension {path}: "
                    f"{e}") from e
            _loaded["ingest"] = mod
        return mod


def wire_library() -> ctypes.CDLL:
    """The loaded telnet decoder with its ctypes signatures, built on
    first use."""
    lib = _loaded.get("wire")
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get("wire")
        if lib is None:
            path = build("wire")
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(
                    f"cannot load the native wire decoder {path}: "
                    f"{e}") from e
            _declare_wire(lib)
            _loaded["wire"] = lib
        return lib


def _declare_wire(lib: ctypes.CDLL) -> None:
    lib.tsd_parse.restype = ctypes.c_void_p
    lib.tsd_parse.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    for fn in ("tsd_npoints", "tsd_nseries", "tsd_nerrors",
               "tsd_consumed"):
        getattr(lib, fn).restype = ctypes.c_size_t
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.tsd_copy_points.restype = None
    lib.tsd_copy_points.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32)]
    lib.tsd_series_name.restype = ctypes.c_char_p
    lib.tsd_series_name.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.tsd_error.restype = ctypes.c_char_p
    lib.tsd_error.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.tsd_free.restype = None
    lib.tsd_free.argtypes = [ctypes.c_void_p]


class _Ingest:
    """The C ingest functions (``native/ingest_ext.c``), each call
    counted."""

    def upsert_cells(self, rows, keys, family, quals, vals, pending):
        calls["upsert_cells"] += 1
        return ingest_module().upsert_cells(rows, keys, family, quals,
                                            vals, pending)

    def rows_update_new(self, rows, keys, family, quals, vals):
        calls["rows_update_new"] += 1
        return ingest_module().rows_update_new(rows, keys, family, quals,
                                               vals)

    def slice_keys(self, blob, key_len):
        calls["slice_keys"] += 1
        return ingest_module().slice_keys(blob, key_len)

    def slice_varlen(self, blob, lens_be):
        calls["slice_varlen"] += 1
        return ingest_module().slice_varlen(blob, lens_be)

    def frame_rows(self, table, keys, cells, base):
        calls["frame_rows"] += 1
        return ingest_module().frame_rows(table, keys, cells, base)

    def frame_rows_dict(self, table, keys, rows, base):
        calls["frame_rows_dict"] += 1
        return ingest_module().frame_rows_dict(table, keys, rows, base)

    def slice_cells(self, quals, vbytes, row_starts, row_ends, val_starts,
                    val_ends):
        calls["slice_cells"] += 1
        return ingest_module().slice_cells(quals, vbytes, row_starts,
                                           row_ends, val_starts, val_ends)


class _Wire:
    """The C telnet decoder (``native/wire_decoder.cpp``); ``tsd_parse``
    is counted, the accessors of its arena pass through."""

    def tsd_parse(self, buf: bytes, n: int):
        calls["tsd_parse"] += 1
        return wire_library().tsd_parse(buf, n)

    def __getattr__(self, name: str):
        return getattr(wire_library(), name)


EXT = _Ingest()
WIRE = _Wire()
