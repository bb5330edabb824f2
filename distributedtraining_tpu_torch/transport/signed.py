"""SignedTransport: Ed25519 authenticity over any byte-capable transport —
the port of the JAX package's ``transport/signed.py``, with the same
policy and the same envelopes (``signing.py``), so a signed fleet may mix
the two packages' roles.

- every publish is signed with this node's Identity, the artifact kind
  and hotkey bound into the signed message (a delta can never be replayed
  as a base, or under another hotkey);
- every fetch is verified against the hotkey's *registered* public key
  (``pubkey_resolver``, normally ``AddressStore.retrieve_pubkey``):

    | artifact state        | key registered | no key registered        |
    |-----------------------|----------------|--------------------------|
    | valid envelope        | accept         | accept                   |
    | forged/tampered       | reject         | reject                   |
    | unsigned              | reject         | accept unless ``strict`` |

  A registered key makes signatures mandatory for that hotkey: a writer
  who cannot sign cannot "downgrade" to unsigned.

Wire-v2 delta shards and base shards travel unsigned: their sha256 rides
the (signed) manifest, which every reader checks. A published base's
context carries a monotonic sequence (``base:<signer>:<unix time>``): a
reader refuses a base whose sequence goes backwards, so a replayed old
but validly signed base cannot roll the fleet back (in memory only: a
fresh node accepts the first base it sees).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional

from .. import serialization as ser
from .. import signing
from . import base as tbase
from .base import Revision

logger = logging.getLogger(__name__)

Params = Any
PubkeyResolver = Callable[[str], Optional[bytes]]


class SignedTransport:
    def __init__(self, inner, *, identity=None,
                 pubkey_resolver: PubkeyResolver | None = None,
                 base_signer: str | None = None,
                 my_hotkey: str | None = None,
                 strict: bool = False,
                 max_bytes: int = ser.DEFAULT_MAX_BYTES,
                 now_fn=None):
        """``identity``: this node's signing key (None: fetch-only).
        ``base_signer``: the hotkey expected to sign the published base
        (the averager); with a registered key for it, base fetches require
        a valid signature. ``my_hotkey``: this node's protocol hotkey, the
        context of its base publishes (what peers configure as
        ``base_signer``). ``strict``: refuse ALL unsigned artifacts."""
        self.inner = inner
        self.identity = identity
        self.pubkey_resolver = pubkey_resolver or (lambda hotkey: None)
        self.base_signer = base_signer
        self.my_hotkey = my_hotkey or (identity.hotkey if identity else "")
        self.strict = strict
        self.max_bytes = max_bytes
        self._now = now_fn or time.time
        # anti-rollback watermark: the highest base sequence accepted
        self._base_seq_seen = 0

    # -- policy -------------------------------------------------------------
    def _open(self, data: bytes, hotkey: str, context: bytes) -> bytes:
        expected = self.pubkey_resolver(hotkey)
        return signing.unwrap(data, context, expected_pub=expected,
                              require=self.strict or expected is not None)

    # -- miner side ---------------------------------------------------------
    def publish_delta(self, miner_id: str, delta: Params) -> Revision:
        data = ser.to_msgpack(delta)
        if self.identity is not None:
            data = signing.wrap(data, self.identity,
                                signing.delta_context(miner_id))
        return self.inner.publish_raw(miner_id, data)

    def publish_raw(self, miner_id: str, data: bytes) -> Revision:
        """Pass-through: pre-built (possibly unsigned or forged) bytes."""
        return self.inner.publish_raw(miner_id, data)

    def publish_delta_raw(self, miner_id: str, data: bytes) -> Revision:
        """This node's own artifact as pre-built bytes (a wire-v2 manifest,
        a lineage record, a base manifest), enveloped under the delta
        context like ``publish_delta``."""
        if self.identity is not None:
            data = signing.wrap(data, self.identity,
                                signing.delta_context(miner_id))
        return self.inner.publish_raw(miner_id, data)

    # -- wire-v2 shards and base shards: unsigned, hash-pinned ---------------
    def publish_shard(self, hotkey: str, layer_key: str,
                      data: bytes) -> None:
        tbase.publish_shard(self.inner, hotkey, layer_key, data)

    def fetch_shard(self, hotkey: str, layer_key: str) -> bytes | None:
        return tbase.fetch_shard(self.inner, hotkey, layer_key)

    def publish_base_shard(self, layer_key: str, data: bytes) -> None:
        tbase.publish_base_shard(self.inner, layer_key, data)

    def fetch_base_shard(self, layer_key: str) -> bytes | None:
        return tbase.fetch_base_shard(self.inner, layer_key)

    # -- validator / averager side -----------------------------------------
    def fetch_delta_bytes(self, miner_id: str) -> bytes | None:
        raw = self.inner.fetch_delta_bytes(miner_id)
        if raw is None:
            return None
        try:
            return self._open(raw, miner_id, signing.delta_context(miner_id))
        except ser.PayloadError as e:
            logger.warning("delta from %s rejected: %s", miner_id, e)
            return None

    def fetch_delta(self, miner_id: str, template: Params) -> Params | None:
        data = self.fetch_delta_bytes(miner_id)
        if data is None:
            return None
        try:
            return ser.validated_load(data, template,
                                      max_bytes=self.max_bytes)
        except ser.PayloadError:
            return None

    def publish_delta_meta(self, miner_id: str, meta: dict) -> None:
        """Rider pass-through, not enveloped: a forged rider can at worst
        mark a miner's own delta stale (self-harm) — the artifact stays
        verified either way."""
        pm = getattr(self.inner, "publish_delta_meta", None)
        if pm is not None:
            pm(miner_id, meta)

    def fetch_delta_meta(self, miner_id: str) -> dict | None:
        fm = getattr(self.inner, "fetch_delta_meta", None)
        return fm(miner_id) if fm is not None else None

    def delta_revision(self, miner_id: str) -> Revision:
        return self.inner.delta_revision(miner_id)

    # -- base model ---------------------------------------------------------
    def publish_base(self, base: Params) -> Revision:
        data = ser.to_msgpack(base)
        if self.identity is not None:
            ctx = (signing.base_context(self.my_hotkey)
                   + b":" + str(int(self._now())).encode())
            data = signing.wrap(data, self.identity, ctx)
        return self.inner.publish_base_raw(data)

    def _open_base(self, raw: bytes) -> bytes | None:
        """With ``base_signer``, the envelope must carry exactly that
        identity's context and key (mandatory once the key is registered)
        and a sequence no older than the last accepted; without it, only
        the artifact kind is enforced."""
        signer = self.base_signer
        try:
            if signer:
                prefix = signing.base_context(signer)
                expected = self.pubkey_resolver(signer)
                payload, ctx = signing.unwrap_with_context(
                    raw, context_prefix=prefix,
                    expected_pub=expected,
                    require=self.strict or expected is not None)
                seq = signing.context_seq(ctx, prefix)
                if seq and seq < self._base_seq_seen:
                    raise ser.PayloadError(
                        f"base sequence rolled back ({seq} < "
                        f"{self._base_seq_seen}) — replayed stale base")
                self._base_seq_seen = max(self._base_seq_seen, seq)
                return payload
            return signing.unwrap(raw, kind=b"base", require=self.strict)
        except ser.PayloadError as e:
            logger.warning("published base rejected: %s", e)
            return None

    def fetch_base(self, template: Params):
        raw = self.inner.fetch_base_bytes()
        if raw is None:
            return None
        data = self._open_base(raw)
        if data is None:
            return None
        try:
            tree = ser.validated_load(data, template,
                                      max_bytes=self.max_bytes)
        except ser.PayloadError:
            return None
        return tree, self.inner.base_revision()

    def base_revision(self) -> Revision:
        return self.inner.base_revision()

    def publish_base_raw(self, data: bytes) -> Revision:
        """Pass-through: pre-built bytes are the caller's to envelope."""
        return self.inner.publish_base_raw(data)

    def fetch_base_bytes(self) -> bytes | None:
        """Raw base bytes, envelope intact."""
        return self.inner.fetch_base_bytes()

    # -- lifecycle ----------------------------------------------------------
    def gc(self) -> None:
        self.inner.gc()
