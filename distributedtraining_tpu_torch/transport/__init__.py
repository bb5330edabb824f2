"""Artifact transports: the Transport protocol, the in-memory and the
local-filesystem backends, and the publish retry policy."""

from .localfs import LocalFSTransport
from .memory import InMemoryTransport

__all__ = ["InMemoryTransport", "LocalFSTransport"]
