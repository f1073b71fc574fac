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


def test_fault_sharded_and_fsck_live_in_the_port():
    """The port's fault points, sharded store and fsck are its own: no
    module names the JAX package's fault, sharded-store or fsck modules,
    and the crash harness spawns the port's harness as its child."""
    import re
    from opentsdb_tpu_torch.fault import harness
    pkg = os.path.join(ROOT, "opentsdb_tpu_torch")
    banned = re.compile(r"opentsdb_tpu\.(fault|storage\.sharded|"
                        r"tools\.fsck)\b")
    for d, dirs, files in os.walk(pkg):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(d, fn)
                assert banned.search(open(path).read()) is None, path
    sc = harness.Scenario(label="x", site="kv.wal.append", mode="crash")
    cmd = harness.child_command(sc, "/store", "/progress")
    assert cmd[1:4] == ["-m", "opentsdb_tpu_torch.fault.harness", "--child"]
    # An entry point of the port: the child runs on the card unless the
    # caller asks for the CPU.
    assert cmd[cmd.index("--device") + 1] == "cuda"
    assert "opentsdb_tpu_torch.fault.harness" in harness.repro_command(sc)


def test_observability_lives_in_the_port():
    """The port's observability layer is its own copy: obs/, the stats
    collector and the log ring exist in the package, each names the JAX
    module it mirrors, no module names the JAX package's obs, collector
    or log-ring modules, and the slow-query log is the port's logger."""
    import importlib
    import re
    from opentsdb_tpu_torch.obs import ring
    mirrors = {
        "opentsdb_tpu_torch.obs.registry": "opentsdb_tpu/obs/registry.py",
        "opentsdb_tpu_torch.obs.trace": "opentsdb_tpu/obs/trace.py",
        "opentsdb_tpu_torch.obs.ring": "opentsdb_tpu/obs/ring.py",
        "opentsdb_tpu_torch.obs.selfmon": "opentsdb_tpu/obs/selfmon.py",
        "opentsdb_tpu_torch.stats.collector":
            "opentsdb_tpu/stats/collector.py",
        "opentsdb_tpu_torch.server.logbuffer":
            "opentsdb_tpu/server/logbuffer.py",
    }
    for mod, src in mirrors.items():
        assert src in importlib.import_module(mod).__doc__, mod
    pkg = os.path.join(ROOT, "opentsdb_tpu_torch")
    banned = re.compile(r"opentsdb_tpu\.(obs|stats\.collector|"
                        r"server\.logbuffer)\b")
    for d, dirs, files in os.walk(pkg):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(d, fn)
                assert banned.search(open(path).read()) is None, path
    assert ring.SLOW_LOG.name == "opentsdb_tpu_torch.slowquery"


def test_compress_and_block_decode_live_in_the_port():
    """The compressed-block slice is the port's own: the compress/ modules
    and csrc/block_decode.cu sit in the package, the kernel builds from
    there, no module names the JAX package's compress modules, and
    codecs.py is the JAX package's file but for the docstring's note and
    the import of the port's constants."""
    import re
    from opentsdb_tpu_torch.ops import cuda_build
    pkg = os.path.join(ROOT, "opentsdb_tpu_torch")
    for rel in ("compress/__init__.py", "compress/codecs.py",
                "compress/kernels.py", "compress/fused.py",
                "compress/devcache.py", "ops/block_decode.py",
                "csrc/block_decode.cu"):
        assert os.path.exists(os.path.join(pkg, rel)), rel
    assert "block_decode" in cuda_build.sources()
    banned = re.compile(r"opentsdb_tpu\.compress\b")
    for d, dirs, files in os.walk(pkg):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(d, fn)
                assert banned.search(open(path).read()) is None, path
    port = open(os.path.join(pkg, "compress", "codecs.py")).read()
    jax = open(os.path.join(ROOT, "opentsdb_tpu", "compress",
                            "codecs.py")).read()
    port = re.sub(r"\nA copy of ``opentsdb_tpu/compress/codecs.py``.*?\n\n",
                  "\n", port, count=1, flags=re.S)
    assert port.replace("opentsdb_tpu_torch.core.const",
                        "opentsdb_tpu.core.const") == jax


def test_build_data_lives_in_the_port():
    """The version surface is the port's own copy of
    opentsdb_tpu/build_data.py: it names that module, and neither the
    daemon nor the CLI names the JAX package's."""
    import re
    from opentsdb_tpu_torch import build_data
    assert "opentsdb_tpu/build_data.py" in build_data.__doc__
    assert build_data.version_string().startswith("opentsdb_tpu_torch ")
    banned = re.compile(r"opentsdb_tpu\.build_data\b")
    for rel in ("server/tsd.py", "tools/cli.py", "build_data.py"):
        src = open(os.path.join(ROOT, "opentsdb_tpu_torch", rel)).read()
        assert banned.search(src) is None, rel
        assert "build_data" in src, rel
