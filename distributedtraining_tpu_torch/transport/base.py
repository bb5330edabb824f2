"""Transport protocol — the port of the JAX package's ``transport/base.py``:
the ``Transport`` protocol, the delta META rider codec, the reserved
artifact ids and the wire-v2 shard helpers (``shard_id``,
``publish_shard``, ``fetch_shard``).

Method mapping to the reference's HFManager (hivetrain/hf_manager.py):

| here                      | reference                                  |
|---------------------------|--------------------------------------------|
| publish_delta             | push_changes("weight_diff.pt") :91-114     |
| fetch_delta               | receive_gradients :186-197                 |
| publish_base              | push_to_hf_hub("averaged_model.pt") :116-136 |
| fetch_base                | pull_latest_model + update_model :161-184  |
| base_revision             | check_for_new_submissions (shared repo) :151-159 |
| delta_revision            | check_for_new_submissions (miner repo)     |
| gc                        | super_squash_history + git lfs prune :73-114 |

Revisions are opaque strings (commit SHA / content hash); ``None`` means "no
artifact yet". Change detection is revision inequality, exactly like the
reference's commit-SHA polling.
"""

from __future__ import annotations

import json
from typing import Any, Optional, Protocol

Params = Any
Revision = Optional[str]

META_MAX_BYTES = 4096

# Reserved artifact ids: control-plane and shard artifacts travel through
# the same per-miner byte surface as deltas, under prefixes no chain
# hotkey starts with. The port publishes wire-v2 shards; the other
# prefixes are the JAX package's fleet planes, kept so a consumer of a
# shared root recognises every reserved id.
HEARTBEAT_PREFIX = "__hb__"
LEASE_PREFIX = "__lease__"
AGG_PREFIX = "__agg__"
PM_PREFIX = "__pm__"
LINEAGE_PREFIX = "__lineage__"
BASE_PREFIX = "__base__"
KV_PREFIX = "__kv__"
MIRROR_PREFIX = "__mirror__"

# Wire-v2 per-layer delta shards (serialization.py shard container,
# engine/publish.py uploads, engine/ingest.py fetches): raw bytes under a
# reserved per-(miner, layer) id, carried by every transport's
# publish_raw / fetch_delta_bytes. The id is layer-stable (a re-publish
# overwrites that layer's previous shard: the storage bound); the content
# address is the manifest's per-shard sha256, which ingest verifies.
SHARD_PREFIX = "__shard__"


def shard_layer_slug(layer_key: str) -> str:
    """Filename/id-safe spelling of a manifest layer key (``/``-joined
    wire path). Injective: literal ``%`` and ``.`` are percent-escaped
    before ``/`` maps to ``.``, so ``a/b.c`` and ``a/b/c`` get distinct
    shard ids."""
    return (layer_key.replace("%", "%25").replace(".", "%2E")
            .replace("/", "."))


def shard_id(hotkey: str, layer_key: str) -> str:
    """The reserved artifact id one miner's per-layer shard travels under
    on id-namespace transports (localfs, memory)."""
    return f"{SHARD_PREFIX}.{hotkey}.{shard_layer_slug(layer_key)}"


def is_shard_id(artifact_id: str) -> bool:
    return isinstance(artifact_id, str) and \
        artifact_id.startswith(SHARD_PREFIX + ".")


def is_reserved_id(artifact_id: str) -> bool:
    """True for any id in the reserved namespace (heartbeats, leases,
    wire-v2 shards, partial aggregates, postmortems, lineage records, base
    shards and manifests, KV pages, mirrors): flat delta consumers never
    stage these as miner submissions."""
    return isinstance(artifact_id, str) and (
        artifact_id == BASE_PREFIX
        or any(artifact_id.startswith(p + ".") for p in (
            HEARTBEAT_PREFIX, LEASE_PREFIX, SHARD_PREFIX, AGG_PREFIX,
            PM_PREFIX, LINEAGE_PREFIX, BASE_PREFIX, KV_PREFIX,
            MIRROR_PREFIX)))


def publish_shard(transport, hotkey: str, layer_key: str,
                  data: bytes) -> None:
    """Publish one shard through the transport's own ``publish_shard``
    when it has one, else ``publish_raw`` under the reserved shard id."""
    ps = getattr(transport, "publish_shard", None)
    if ps is not None:
        ps(hotkey, layer_key, data)
        return
    transport.publish_raw(shard_id(hotkey, layer_key), data)


def fetch_shard(transport, hotkey: str, layer_key: str) -> bytes | None:
    """One shard's raw bytes (or None). Integrity is the caller's: it
    verifies the bytes against the manifest's content hash."""
    fs = getattr(transport, "fetch_shard", None)
    if fs is not None:
        return fs(hotkey, layer_key)
    return transport.fetch_delta_bytes(shard_id(hotkey, layer_key))


def encode_delta_meta(meta: dict) -> bytes:
    """Serialize a metadata rider (tiny JSON; size-capped on read)."""
    return json.dumps(meta).encode()


def parse_delta_meta(data: bytes | None) -> dict | None:
    """Parse PEER-CONTROLLED rider bytes defensively: size-capped, must be
    a JSON object, and the protocol-read key (``base_revision``) must be a
    short string. Anything else reads as None (= no rider = reference
    accept-anything behavior), never an exception."""
    if data is None or len(data) > META_MAX_BYTES:
        return None
    try:
        meta = json.loads(data)
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(meta, dict):
        return None
    rev = meta.get("base_revision")
    if rev is not None and not (isinstance(rev, str) and len(rev) <= 200):
        return None
    return meta


class Transport(Protocol):
    # -- miner side ---------------------------------------------------------
    def publish_delta(self, miner_id: str, delta: Params) -> Revision:
        """Upload this miner's current weight delta (overwrites previous)."""
        ...

    def publish_raw(self, miner_id: str, data: bytes) -> Revision:
        """Pre-serialized (possibly signature-enveloped, possibly hostile)
        delta bytes — SignedTransport publishes through this, and the load
        generator uses it to simulate miners that don't run our code."""
        ...

    # OPTIONAL (wrappers only; callers fall back to publish_raw via
    # getattr): bytes that ARE this node's own delta artifact — the
    # wire-v2 manifest publish goes through here so SignedTransport can
    # envelope it under the delta context exactly like a publish_delta,
    # while plain transports treat it as publish_raw. Distinct from
    # publish_raw, whose contract is "pass hostile bytes through
    # untouched".
    # def publish_delta_raw(self, miner_id: str, data: bytes) -> Revision

    # -- validator / averager side -----------------------------------------
    def fetch_delta(self, miner_id: str, template: Params) -> Params | None:
        """Download + validate a miner's delta; None if absent or invalid.
        Must tolerate (strip, unverified) signature envelopes."""
        ...

    def fetch_delta_bytes(self, miner_id: str) -> bytes | None:
        """Raw size-capped artifact bytes, one network read — for
        multi-template validation (full-param vs LoRA wire forms) and for
        SignedTransport's signature verification. Envelopes are returned
        INTACT here."""
        ...

    def delta_revision(self, miner_id: str) -> Revision:
        """Current revision of the miner's delta artifact, or None when
        absent. CONTRACT: this must be cheap relative to the artifact
        fetch (a commit-SHA read, a stat-cached content hash) — the
        ingest cache (engine/ingest.py) probes it once per miner per
        round and skips the download entirely when it is unchanged, so a
        probe that costs like a download erases the point. It must also
        be stable: equal revisions MUST imply identical artifact bytes
        (the cache serves the decoded tree keyed on it)."""
        ...

    # -- delta metadata rider (optional; absent = reference behavior) ------
    # The same channel carries fleet heartbeats under the reserved
    # ``heartbeat_id(role, hotkey)`` ids (module-level contract above):
    # implementations must treat those ids like any other per-miner id
    # (opaque strings), which all built-ins already do.
    def publish_delta_meta(self, miner_id: str, meta: dict) -> None:
        """Small JSON rider next to the delta artifact. The one key the
        protocol reads is ``base_revision`` — the base the delta was
        computed against — which lets receivers detect STALE deltas (a
        delta vs base N applied to base N+1 re-adds the part of the
        N->N+1 update the miner had already incorporated; the reference
        silently double-applies). Peer-controlled: readers must treat the
        contents as untrusted."""
        ...

    def fetch_delta_meta(self, miner_id: str) -> dict | None:
        """The rider for ``miner_id``, or None (absent/unparseable —
        receivers then fall back to the reference's accept-anything)."""
        ...

    # -- base model (averager publishes, everyone pulls) -------------------
    def publish_base(self, base: Params) -> Revision:
        ...

    def publish_base_raw(self, data: bytes) -> Revision:
        """Byte-level twin of publish_base (signature envelopes)."""
        ...

    def fetch_base(self, template: Params) -> tuple[Params, Revision] | None:
        ...

    def fetch_base_bytes(self) -> bytes | None:
        """Raw base bytes, envelope intact (SignedTransport verification)."""
        ...

    def base_revision(self) -> Revision:
        ...

    # -- lifecycle ----------------------------------------------------------
    def gc(self) -> None:
        """Bound storage (the reference squashes git history + prunes LFS)."""
        ...
