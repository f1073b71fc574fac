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


def test_rollup_slice_lives_in_the_port():
    """The rollup slice is the port's own: rollup/, sketch/moment.py,
    sketch/bounds.py and ops/rollup_fold.py each name the JAX module they
    mirror (the kernel its TPU function), csrc/rollup_fold.cu builds from
    the package, no module names the JAX package's rollup or sketch
    modules, and the numpy modules copied whole are the JAX files but for
    the docstring's note and the package name."""
    import importlib
    import re
    from opentsdb_tpu_torch.ops import cuda_build
    mirrors = {
        "opentsdb_tpu_torch.rollup.summary": "opentsdb_tpu/rollup/summary.py",
        "opentsdb_tpu_torch.rollup.tier": "opentsdb_tpu/rollup/tier.py",
        "opentsdb_tpu_torch.rollup.delta": "opentsdb_tpu/rollup/delta.py",
        "opentsdb_tpu_torch.rollup.planner":
            "opentsdb_tpu/rollup/planner.py",
        "opentsdb_tpu_torch.rollup": "opentsdb_tpu/rollup/",
        "opentsdb_tpu_torch.sketch.moment": "opentsdb_tpu/sketch/moment.py",
        "opentsdb_tpu_torch.sketch.bounds": "opentsdb_tpu/sketch/bounds.py",
        "opentsdb_tpu_torch.ops.rollup_fold":
            "opentsdb_tpu/rollup/summary.py",
    }
    for mod, src in mirrors.items():
        assert src in importlib.import_module(mod).__doc__, mod
    assert "rollup_fold" in cuda_build.sources()
    pkg = os.path.join(ROOT, "opentsdb_tpu_torch")
    cu = open(os.path.join(pkg, "csrc", "rollup_fold.cu")).read()
    assert "opentsdb_tpu/rollup/summary.py _device_fold_fn" in cu
    banned = re.compile(r"opentsdb_tpu\.(rollup|sketch)\b")
    for d, dirs, files in os.walk(pkg):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(d, fn)
                assert banned.search(open(path).read()) is None, path
    for rel in ("sketch/moment.py", "sketch/bounds.py", "rollup/delta.py",
                "rollup/planner.py"):
        port = open(os.path.join(pkg, rel)).read()
        jax = open(os.path.join(ROOT, "opentsdb_tpu", rel)).read()
        port = re.sub(r"\n\nMirrors ``opentsdb_tpu/.*?\n\n", "\n\n", port,
                      count=1, flags=re.S)
        # One comment names the reference's own history differently.
        jax = jax.replace("(PR-13 pre-release)", "(a pre-release)")
        assert port.replace("opentsdb_tpu_torch.", "opentsdb_tpu.") == jax, \
            rel


def test_smoothing_and_approx_slice_lives_in_the_port():
    """The smoothing and approximate-serving slice is the port's own:
    models/, ops/smoothing.py, sketch/serving.py and sketch/budget.py
    each name the JAX module they mirror, csrc/smoothing.cu builds from
    the package and names the scans it replaces, no module names the JAX
    package's models module, and budget.py is the JAX file but for its
    docstring and the package name."""
    import importlib
    import re
    from opentsdb_tpu_torch.ops import cuda_build
    mirrors = {
        "opentsdb_tpu_torch.models": "opentsdb_tpu/models/",
        "opentsdb_tpu_torch.models.smoothing":
            "opentsdb_tpu/models/smoothing.py",
        "opentsdb_tpu_torch.models.forecast": "opentsdb_tpu/server/tsd.py",
        "opentsdb_tpu_torch.ops.smoothing":
            "opentsdb_tpu/models/smoothing.py",
        "opentsdb_tpu_torch.sketch.serving":
            "opentsdb_tpu/sketch/serving.py",
        "opentsdb_tpu_torch.sketch.budget": "opentsdb_tpu/sketch/budget.py",
    }
    for mod, src in mirrors.items():
        assert src in importlib.import_module(mod).__doc__, mod
    assert "smoothing" in cuda_build.sources()
    pkg = os.path.join(ROOT, "opentsdb_tpu_torch")
    cu = open(os.path.join(pkg, "csrc", "smoothing.cu")).read()
    assert "opentsdb_tpu/models/smoothing.py" in cu
    for fn in ("ewma_scan_f32", "holt_winters_bands_f32", "__fmul_rn",
               "sqrt_core"):
        assert fn in cu, fn
    banned = re.compile(r"opentsdb_tpu\.models\b")
    for d, dirs, files in os.walk(pkg):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(d, fn)
                assert banned.search(open(path).read()) is None, path
    port = open(os.path.join(pkg, "sketch", "budget.py")).read()
    jax = open(os.path.join(ROOT, "opentsdb_tpu", "sketch",
                            "budget.py")).read()
    strip = lambda s: s.split('"""', 2)[2]  # noqa: E731
    # One docstring names the JAX project's history differently.
    jax = re.sub(r"\(the \S+ slow-query/ambient-sample ring",
                 "(the slow-query / ambient-sample ring", jax)
    assert strip(port).replace("opentsdb_tpu_torch.", "opentsdb_tpu.") == \
        strip(jax)


def test_replica_slice_lives_in_the_port():
    """The replica and epoch-fence slice is the port's own: cluster/ and
    serve/tailer.py name the JAX modules they mirror, and no module of
    the port names the JAX package's cluster or serve modules."""
    import importlib
    import re
    mirrors = {
        "opentsdb_tpu_torch.cluster": "opentsdb_tpu/cluster/",
        "opentsdb_tpu_torch.cluster.epoch": "opentsdb_tpu/cluster/epoch.py",
        "opentsdb_tpu_torch.serve.tailer": "opentsdb_tpu/serve/tailer.py",
    }
    for mod, src in mirrors.items():
        assert src in importlib.import_module(mod).__doc__, mod
    banned = re.compile(r"opentsdb_tpu\.(cluster|serve)\b")
    pkg = os.path.join(ROOT, "opentsdb_tpu_torch")
    for d, dirs, files in os.walk(pkg):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(d, fn)
                assert banned.search(open(path).read()) is None, path


_ROUTER_CHAIN = """
import sys
import opentsdb_tpu_torch.cluster.ownership
import opentsdb_tpu_torch.cluster.promote
import opentsdb_tpu_torch.serve.router as router
from opentsdb_tpu_torch.tools import cli
args = cli.build_parser().parse_args([
    "tsd", "--role", "router", "--port", "0",
    "--backends", "http://127.0.0.1:1,http://127.0.0.1:2",
    "--writer-url", "http://127.0.0.1:3", "--writer-grace-ms", "500"])
server = router.RouterServer(cli.router_config(args))
assert server.promotion is not None and len(server.backends) == 2
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib")
             or m.startswith(("opentsdb_tpu.", "opentsdb_tpu_torch.core",
                              "opentsdb_tpu_torch.storage",
                              "opentsdb_tpu_torch.server"))))
"""


def test_router_chain_loads_no_torch_jax_or_storage():
    """``tsd --role router`` up to its RouterServer (the router, the
    ownership map, the promotion manager, the CLI and its Config) loads
    neither torch nor jax, nor the storage engine, the core or the
    daemon: a router restarts in well under a second."""
    out = subprocess.run([sys.executable, "-c", _ROUTER_CHAIN],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_router_slice_lives_in_the_port():
    """The router slice is the port's own: each module names the JAX
    module it mirrors, no module of the port names the JAX package's
    cluster, serve or tools modules, and the serve matrix spawns the
    port's CLI, never the JAX one or scripts/."""
    import importlib
    import re
    mirrors = {
        "opentsdb_tpu_torch.cluster.ownership":
            "opentsdb_tpu/cluster/ownership.py",
        "opentsdb_tpu_torch.cluster.promote":
            "opentsdb_tpu/cluster/promote.py",
        "opentsdb_tpu_torch.serve.router": "opentsdb_tpu/serve/router.py",
        "opentsdb_tpu_torch.tools.servematrix": "scripts/servematrix.py",
    }
    for mod, src in mirrors.items():
        assert src in importlib.import_module(mod).__doc__, mod
    banned = re.compile(r"opentsdb_tpu\.(cluster|serve|tools)\b")
    pkg = os.path.join(ROOT, "opentsdb_tpu_torch")
    for d, dirs, files in os.walk(pkg):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(d, fn)
                assert banned.search(open(path).read()) is None, path
    from opentsdb_tpu_torch.tools import servematrix
    assert servematrix.CLI == "opentsdb_tpu_torch.tools.cli"
    src = open(servematrix.__file__).read()
    assert "sys.path.insert" not in src and "import scripts" not in src
    from opentsdb_tpu_torch.tools import cli
    assert cli.build_parser().parse_args(
        ["tsd", "--role", "router"]).device == "cuda"


_IMPORT_MESH = """
import importlib, sys
for name in ("opentsdb_tpu_torch.parallel", "opentsdb_tpu_torch.parallel.mesh",
             "opentsdb_tpu_torch.parallel.plan",
             "opentsdb_tpu_torch.parallel.compile",
             "opentsdb_tpu_torch.parallel.sharded",
             "opentsdb_tpu_torch.parallel.timeshard",
             "opentsdb_tpu_torch.storage.devshard",
             "opentsdb_tpu_torch.ops.mesh_combine"):
    importlib.import_module(name)
print(sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "opentsdb_tpu" or m.startswith("opentsdb_tpu.")))
"""


def test_mesh_slice_lives_in_the_port():
    """The serving mesh in one process (parallel/, storage/devshard.py,
    ops/mesh_combine.py) loads no jax and nothing of the JAX package,
    names the JAX module each mirrors, no port module names the JAX
    package's parallel modules, and csrc/mesh_combine.cu builds from the
    package with the _rn rounding its bit-exact contract needs."""
    import importlib
    import re
    from opentsdb_tpu_torch.ops import cuda_build
    out = subprocess.run([sys.executable, "-c", _IMPORT_MESH], cwd=ROOT,
                         check=True, capture_output=True, text=True,
                         timeout=120).stdout
    assert out.strip() == "[]"
    mirrors = {
        "opentsdb_tpu_torch.parallel.mesh": "opentsdb_tpu/parallel/mesh.py",
        "opentsdb_tpu_torch.parallel.plan": "opentsdb_tpu/parallel/plan.py",
        "opentsdb_tpu_torch.parallel.compile":
            "opentsdb_tpu/parallel/compile.py",
        "opentsdb_tpu_torch.parallel.sharded":
            "opentsdb_tpu/parallel/sharded.py",
        "opentsdb_tpu_torch.parallel.timeshard":
            "opentsdb_tpu/parallel/timeshard.py",
        "opentsdb_tpu_torch.storage.devshard":
            "opentsdb_tpu/storage/devshard.py",
        "opentsdb_tpu_torch.parallel": "opentsdb_tpu/parallel/",
    }
    for mod, src in mirrors.items():
        assert src in importlib.import_module(mod).__doc__, mod
    assert "mesh_combine" in cuda_build.sources()
    pkg = os.path.join(ROOT, "opentsdb_tpu_torch")
    cu = open(os.path.join(pkg, "csrc", "mesh_combine.cu")).read()
    for fn in ("moment_combine_f32", "tile_carries_i32f32", "__fadd_rn",
               "__fmul_rn", "__fdiv_rn", "__fsqrt_rn",
               "opentsdb_tpu/parallel/sharded.py",
               "opentsdb_tpu/parallel/timeshard.py"):
        assert fn in cu, fn
    banned = re.compile(r"opentsdb_tpu\.parallel\b")
    for d, dirs, files in os.walk(pkg):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(d, fn)
                assert banned.search(open(path).read()) is None, path


_IMPORT_11B = """
import importlib, sys
for name in ("opentsdb_tpu_torch.parallel.multihost",
             "opentsdb_tpu_torch.parallel.fleet",
             "opentsdb_tpu_torch.parallel.expert",
             "opentsdb_tpu_torch.ops.expert_finish",
             "opentsdb_tpu_torch.tools.multihost_run"):
    importlib.import_module(name)
print(sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "opentsdb_tpu" or m.startswith("opentsdb_tpu.")))
"""


def test_expert_and_fleet_slice_lives_in_the_port():
    """The hybrid mesh, the mesh plane and the expert batches
    (parallel/multihost.py, fleet.py, expert.py, ops/expert_finish.py,
    tools/multihost_run.py) load no jax and nothing of the JAX package,
    name the JAX modules they mirror, and their kernels build from the
    package's csrc with the _rn rounding their bit-exact contracts
    need."""
    import importlib
    from opentsdb_tpu_torch.ops import cuda_build
    out = subprocess.run([sys.executable, "-c", _IMPORT_11B], cwd=ROOT,
                         check=True, capture_output=True, text=True,
                         timeout=120).stdout
    assert out.strip() == "[]"
    mirrors = {
        "opentsdb_tpu_torch.parallel.multihost":
            "opentsdb_tpu/parallel/multihost.py",
        "opentsdb_tpu_torch.parallel.fleet": "opentsdb_tpu/parallel/fleet.py",
        "opentsdb_tpu_torch.parallel.expert":
            "opentsdb_tpu/parallel/expert.py",
        "opentsdb_tpu_torch.ops.expert_finish":
            "opentsdb_tpu/parallel/expert.py",
        "opentsdb_tpu_torch.tools.multihost_run": "scripts/multihost_run.py",
    }
    for mod, src in mirrors.items():
        assert src in importlib.import_module(mod).__doc__, mod
    assert {"expert", "mesh_combine"} <= set(cuda_build.sources())
    pkg = os.path.join(ROOT, "opentsdb_tpu_torch")
    cu = open(os.path.join(pkg, "csrc", "expert.cu")).read()
    for fn in ("dash_finish_f32", "__fdiv_rn", "__fsqrt_rn",
               "opentsdb_tpu/parallel/expert.py"):
        assert fn in cu, fn
    cu = open(os.path.join(pkg, "csrc", "mesh_combine.cu")).read()
    for fn in ("hybrid_moment_combine_f32",
               "opentsdb_tpu/parallel/multihost.py"):
        assert fn in cu, fn
    # The tool writes only where it is told to.
    src = open(os.path.join(pkg, "tools", "multihost_run.py")).read()
    assert "write_artifacts" not in src and "REPO" not in src
