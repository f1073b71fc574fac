"""The port stands alone: importing it loads neither JAX nor any module of
the JAX package, and its entry points default to the CUDA card and refuse
to run without one."""

import os
import subprocess
import sys

import pytest
import torch

from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.query.executor import QueryExecutor
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import opentsdb_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "opentsdb_tpu" or m.startswith("opentsdb_tpu."))
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, check=True,
        capture_output=True, text=True, timeout=120).stdout.split(None, 1)
    assert int(out[0]) >= 20          # every module was walked
    assert out[1].strip() == "[]"


def test_default_device_is_cuda():
    assert Config().device == "cuda"
    assert Config().backend == "device"


def test_default_construction_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSDB(MemKVStore(), start_compaction_thread=False)


def test_cpu_is_only_taken_when_asked():
    tsdb = TSDB(MemKVStore(), Config(device="cpu"),
                start_compaction_thread=False)
    assert QueryExecutor(tsdb).device == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


_IMPORT_SMOKE = """
import sys
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "opentsdb_tpu" or m.startswith("opentsdb_tpu."))
print(bad)
"""


def test_chip_smoke_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_SMOKE], cwd=ROOT, check=True,
        capture_output=True, text=True, timeout=120).stdout
    assert out.strip() == "[]"


def test_device_window_defaults_to_the_card(monkeypatch):
    from opentsdb_tpu_torch.storage.devstore import DeviceWindow
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceWindow(background=False)
    assert DeviceWindow(background=False, device="cpu").device \
        == torch.device("cpu")


def test_live_sketches_default_to_the_card(monkeypatch, tmp_path):
    from opentsdb_tpu_torch.ops import sketches
    from opentsdb_tpu_torch.stats.livesketch import LiveSketches
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LiveSketches(background=False)
    sk = LiveSketches(background=False, device="cpu")
    assert sk.device == torch.device("cpu")
    path = str(tmp_path / "s.npz")
    sk.save(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LiveSketches.load(path)
    assert LiveSketches.load(path, device="cpu").device \
        == torch.device("cpu")
    for init in (sketches.tdigest_init, sketches.hll_init):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init()


def test_native_sources_live_in_the_port():
    """The port builds its own copies of the native sources: every C/C++
    source of the package sits in opentsdb_tpu_torch/native/, the loader
    builds from there into the package's _build/, and no module names the
    repo-root native/ directory, the JAX package's library names or
    opentsdb_tpu.utils.nativeext (the import walk above would also catch
    an import of it)."""
    import re
    from opentsdb_tpu_torch.utils import nativeext
    pkg = os.path.join(ROOT, "opentsdb_tpu_torch")
    assert nativeext.NATIVE_DIR == os.path.join(pkg, "native")
    assert nativeext.BUILD_DIR == os.path.join(pkg, "_build")
    sources, modules = [], []
    for d, dirs, files in os.walk(pkg):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        for fn in files:
            path = os.path.join(d, fn)
            if fn.endswith((".c", ".cc", ".cpp", ".h", ".hpp")):
                sources.append(os.path.relpath(path, pkg))
            elif fn.endswith(".py"):
                modules.append(path)
    assert sorted(sources) == ["native/ingest_ext.c",
                               "native/wire_decoder.cpp"]
    named = re.compile(r"""["']native["']""")
    for path in modules:
        text = open(path).read()
        assert "opentsdb_tpu.utils.nativeext" not in text, path
        assert "libtsdwire.so" not in text, path
        assert re.search(r"""tsd_ingest_ext["']""", text) is None, path
        if path != os.path.join(pkg, "utils", "nativeext.py"):
            assert named.search(text) is None, path
