"""Chain layer — the port of the JAX package's ``chain/``: the
``AddressStore``/``Network`` protocols and ``Metagraph`` (``base``), and the
JSON-file simulator ``LocalChain`` + ``LocalAddressStore`` (``local``).
The bittensor chain needs the network and is not ported (slice 7)."""

from .base import AddressStore, Metagraph, Network
from .local import LocalAddressStore, LocalChain

__all__ = ["AddressStore", "Metagraph", "Network", "LocalAddressStore",
           "LocalChain"]
