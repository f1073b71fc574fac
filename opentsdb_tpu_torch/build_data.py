"""Build/runtime provenance for the ``version`` RPCs and CLI.

The port's copy of ``opentsdb_tpu/build_data.py``: the same seven keys,
resolved the same way, with ``version_string()`` naming
``opentsdb_tpu_torch``.

Parity: the reference generates a BuildData.java at build time
(build-aux/gen_build_data.sh) carrying git revision, repo status, user,
host, and timestamp, surfaced by the telnet ``version`` command and
``/version`` endpoint (src/tsd/RpcHandler.java:396-421). A source-run
Python package has no build step, so the same facts are resolved at
runtime: revision/status from the live git checkout when the package
sits in one, "unknown" otherwise (e.g. installed into site-packages).
"""

from __future__ import annotations

import functools
import getpass
import os
import socket
import subprocess
import time

from opentsdb_tpu_torch import __version__


# Resolved at import: "since when" must mean process start, not the
# first time someone asks for the version.
_PROCESS_START = int(time.time())


def _git(*args: str) -> str | None:
    root = os.path.dirname(os.path.dirname(__file__))
    # Only trust git when this package itself sits in a checkout: from
    # site-packages, git would walk up and report some unrelated
    # enclosing repository's revision as ours.
    if not os.path.isdir(os.path.join(root, ".git")):
        return None
    try:
        out = subprocess.run(
            ("git", "-C", root) + args,
            capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


@functools.lru_cache(maxsize=1)
def build_data() -> dict:
    """Resolved once per process; cheap to call anywhere."""
    revision = _git("rev-parse", "HEAD") or "unknown"
    dirty = _git("status", "--porcelain")
    status = ("unknown" if dirty is None
              else "MODIFIED" if dirty else "MINT")
    try:
        user = getpass.getuser()
    except Exception:  # no passwd entry in minimal containers
        user = "unknown"
    return {
        "version": __version__,
        "short_revision": revision[:7],
        "full_revision": revision,
        "repo_status": status,
        "user": user,
        "host": socket.gethostname(),
        "timestamp": _PROCESS_START,
    }


def version_string() -> str:
    """Two lines, shaped like the reference's BuildData.revisionString()
    and buildString()."""
    d = build_data()
    when = time.strftime("%Y/%m/%d %H:%M:%S +0000",
                         time.gmtime(d["timestamp"]))
    return (f"opentsdb_tpu_torch {d['version']} built from revision "
            f"{d['short_revision']} ({d['repo_status']})\n"
            f"Running on {d['host']} as {d['user']} since {when}\n")
