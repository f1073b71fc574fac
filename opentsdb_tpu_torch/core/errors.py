"""Exceptions shared across the framework.

Mirrors ``opentsdb_tpu/core/errors.py`` of the JAX package, copied rather
than imported: the port imports nothing of that package.
"""


class IllegalDataError(Exception):
    """Corrupt or semantically invalid stored data.

    Raised by the codec / compaction paths on out-of-order duplicates,
    undecodable cells, or malformed values (parity with the reference's
    net.opentsdb.core.IllegalDataException).
    """


class BadRequestError(Exception):
    """An HTTP 400-class client error (reference src/tsd/BadRequestException.java)."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


class NoSuchUniqueName(Exception):
    """Name -> UID lookup failed (reference src/uid/NoSuchUniqueName.java)."""

    def __init__(self, kind: str, name: str):
        super().__init__(f"No such name for '{kind}': '{name}'")
        self.kind = kind
        self.name = name


class NoSuchUniqueId(Exception):
    """UID -> name lookup failed (reference src/uid/NoSuchUniqueId.java)."""

    def __init__(self, kind: str, uid: bytes):
        super().__init__(f"No such unique ID for '{kind}': {uid.hex()}")
        self.kind = kind
        self.id = uid
