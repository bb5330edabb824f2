"""In-memory transport: the fastest test backend — the port of the JAX
package's ``transport/memory.py``.

Stores serialized bytes (not live pytrees) so the full serialize → validate →
deserialize path runs exactly as it would over the wire.
"""

from __future__ import annotations

import hashlib
from typing import Any

from .. import serialization as ser
from .. import signing
from .base import Revision, encode_delta_meta, parse_delta_meta

Params = Any


class InMemoryTransport:
    def __init__(self):
        self._deltas: dict[str, bytes] = {}
        self._delta_meta: dict[str, bytes] = {}
        self._base: bytes | None = None
        # revision cache, computed at publish: ingest probes every miner's
        # revision every round (engine/ingest.py), and re-hashing a
        # full-model payload per probe is O(model bytes) of pure CPU for
        # bytes that did not change
        self._delta_revs: dict[str, str] = {}
        self._base_rev: str | None = None

    # -- miner side ---------------------------------------------------------
    def publish_delta(self, miner_id: str, delta: Params) -> Revision:
        return self.publish_raw(miner_id, ser.to_msgpack(delta))

    def publish_raw(self, miner_id: str, data: bytes) -> Revision:
        """Arbitrary bytes as a 'delta' — hostile-miner simulation for the
        admission screens (utils/loadgen.py); a real adversary is not
        obliged to run our serializer."""
        self._deltas[miner_id] = bytes(data)
        self._delta_revs[miner_id] = hashlib.sha256(
            self._deltas[miner_id]).hexdigest()
        return self._delta_revs[miner_id]

    # -- validator / averager side -----------------------------------------
    def fetch_delta(self, miner_id: str, template: Params) -> Params | None:
        data = self._deltas.get(miner_id)
        if data is None:
            return None
        try:
            return ser.from_msgpack(signing.strip_envelope(data), template)
        except ser.PayloadError:
            return None

    def fetch_delta_bytes(self, miner_id: str) -> bytes | None:
        """Raw artifact bytes, one fetch — callers that must validate
        against several templates (full-param vs LoRA adapter) run all
        attempts on the same payload."""
        return self._deltas.get(miner_id)

    def delta_revision(self, miner_id: str) -> Revision:
        if miner_id not in self._deltas:
            return None
        rev = self._delta_revs.get(miner_id)
        if rev is None:  # bytes injected behind the API (test doubles)
            rev = self._delta_revs[miner_id] = hashlib.sha256(
                self._deltas[miner_id]).hexdigest()
        return rev

    def publish_delta_meta(self, miner_id: str, meta: dict) -> None:
        self._delta_meta[miner_id] = encode_delta_meta(meta)

    def fetch_delta_meta(self, miner_id: str) -> dict | None:
        return parse_delta_meta(self._delta_meta.get(miner_id))

    # -- base model ---------------------------------------------------------
    def publish_base(self, base: Params) -> Revision:
        return self.publish_base_raw(ser.to_msgpack(base))

    def publish_base_raw(self, data: bytes) -> Revision:
        """Pre-serialized base bytes."""
        self._base = bytes(data)
        self._base_rev = hashlib.sha256(self._base).hexdigest()
        return self._base_rev

    def fetch_base_bytes(self) -> bytes | None:
        return self._base

    def fetch_base(self, template: Params):
        if self._base is None:
            return None
        try:
            tree = ser.from_msgpack(signing.strip_envelope(self._base),
                                    template)
        except ser.PayloadError:
            return None
        return tree, self.base_revision()

    def base_revision(self) -> Revision:
        if self._base is None:
            return None
        if self._base_rev is None:  # bytes injected behind the API
            self._base_rev = hashlib.sha256(self._base).hexdigest()
        return self._base_rev

    def gc(self) -> None:
        pass  # nothing accumulates: publishes overwrite
