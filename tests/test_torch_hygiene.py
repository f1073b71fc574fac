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
