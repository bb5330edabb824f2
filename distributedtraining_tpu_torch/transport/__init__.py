"""Artifact transports: the Transport protocol, the in-memory and the
local-filesystem backends, the signing wrapper and the publish retry
policy."""

from .localfs import LocalFSTransport
from .memory import InMemoryTransport
from .signed import SignedTransport

__all__ = ["InMemoryTransport", "LocalFSTransport", "SignedTransport"]
