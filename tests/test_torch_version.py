"""The port's version surface against the JAX package's: build_data()'s
keys, ``/version?json``, plain ``/version``, telnet ``version`` and the
``version`` CLI subcommand (the reference's BuildData, surfaced by
src/tsd/RpcHandler.java:396-421)."""

import asyncio
import json
import re

import pytest

import opentsdb_tpu.build_data as jax_bd
import opentsdb_tpu_torch.build_data as port_bd
from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.server.tsd import TSDServer as JaxServer
from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
from opentsdb_tpu.tools import cli as jax_cli
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.tools import cli as port_cli
from opentsdb_tpu_torch.utils.config import Config

# version_string()'s two lines; the package name is the one difference.
SHAPE = re.compile(
    r"(?P<pkg>opentsdb_tpu(?:_torch)?) (?P<version>\S+) built from "
    r"revision (?P<rev>\S+) \((?P<status>MINT|MODIFIED|unknown)\)\n"
    r"Running on (?P<host>\S+) as (?P<user>\S+) since "
    r"\d{4}/\d\d/\d\d \d\d:\d\d:\d\d \+0000\n")
PORT_EXTRAS = {"torch", "device"}


def _fields(text: str, pkg: str) -> dict:
    m = SHAPE.fullmatch(text)
    assert m is not None, text
    got = m.groupdict()
    assert got.pop("pkg") == pkg
    return got


def _daemons():
    cfg = dict(auto_create_metrics=True, port=0, bind="127.0.0.1")
    return {
        "jax": (JaxServer, JaxTSDB(JaxStore(),
                                   JaxConfig(device_window=False, **cfg),
                                   start_compaction_thread=False)),
        "port": (TSDServer, TSDB(MemKVStore(), Config(device="cpu", **cfg),
                                 start_compaction_thread=False))}


async def _get(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nConnection: close\r\n\r\n"
                 .encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body.decode()


async def _telnet_version(port):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"version\nexit\n")
    await writer.drain()
    out = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    return out.decode()


def _ask_both(ask):
    """``ask(port)`` against each daemon: {"jax": ..., "port": ...}."""
    out = {}
    for name, (cls, tsdb) in _daemons().items():
        server = cls(tsdb)

        async def main():
            await server.start()
            try:
                return await ask(server.port)
            finally:
                await server.stop()
        try:
            out[name] = asyncio.run(main())
        finally:
            tsdb.shutdown()
    return out


def test_build_data_resolves_the_jax_keys():
    """The same seven keys, the same facts about this checkout and host;
    the timestamp is each module's import, i.e. the process start."""
    want, got = jax_bd.build_data(), port_bd.build_data()
    assert list(got) == list(want)
    for k in ("version", "short_revision", "full_revision", "repo_status",
              "user", "host"):
        assert got[k] == want[k], k
    assert abs(got["timestamp"] - want["timestamp"]) <= 60
    assert got["short_revision"] == got["full_revision"][:7]
    assert port_bd.version_string().startswith("opentsdb_tpu_torch ")


def test_version_json_has_the_jax_daemon_keys():
    answers = _ask_both(lambda port: _get(port, "/version?json"))
    bodies = {}
    for name, (status, body) in answers.items():
        assert status == 200, name
        bodies[name] = json.loads(body)
    want, got = bodies["jax"], bodies["port"]
    assert set(want) == set(jax_bd.build_data()) | {"start_time"}
    assert set(got) == set(want) | PORT_EXTRAS
    assert got["device"] == "cpu"
    for k in ("version", "short_revision", "full_revision", "repo_status",
              "user", "host"):
        assert got[k] == want[k], k
    assert isinstance(got["start_time"], int)
    assert got["start_time"] >= got["timestamp"]


@pytest.mark.parametrize("route", ["http", "telnet"])
def test_version_text_has_the_jax_daemon_shape(route):
    """Plain /version and telnet ``version``: version_string()'s two
    lines, field for field the JAX daemon's but for the package name."""
    if route == "http":
        answers = _ask_both(lambda port: _get(port, "/version"))
        assert {s for s, _ in answers.values()} == {200}
        texts = {k: body for k, (_, body) in answers.items()}
    else:
        texts = _ask_both(_telnet_version)
    assert _fields(texts["port"], "opentsdb_tpu_torch") == _fields(
        texts["jax"], "opentsdb_tpu")
    assert texts["port"] == port_bd.version_string()


@pytest.mark.parametrize("verbose", [False, True])
def test_version_cli_prints_the_jax_shape(capsys, verbose):
    argv = ["version"] + (["--verbose"] if verbose else [])
    assert port_cli.main(argv) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    head = len(port_bd.version_string())
    assert _fields(got[:head], "opentsdb_tpu_torch") == _fields(
        want[:len(jax_bd.version_string())], "opentsdb_tpu")
    rest = got[head:].splitlines()
    if verbose:
        assert [ln.split(":", 1)[0] for ln in rest] == list(
            port_bd.build_data())
        assert [ln.split(":", 1)[0]
                for ln in want[len(jax_bd.version_string()):].splitlines()
                ] == list(jax_bd.build_data())
    else:
        assert rest == []
