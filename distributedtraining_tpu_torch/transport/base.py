"""Transport protocol — the port of the JAX package's ``transport/base.py``:
the ``Transport`` protocol, the delta META rider codec, the reserved
artifact ids and their helpers: wire-v2 delta shards (``shard_id``,
``publish_shard``, ``fetch_shard``), base shards and manifests
(``publish_base_shard``, ``publish_base_manifest``, ...), lineage
records and postmortem bundles.

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
# hotkey starts with. The port publishes wire-v2 shards, base shards and
# manifests, lineage records, postmortem bundles, leases, partial
# aggregates and mirror replicas; heartbeats and KV pages are the JAX
# package's planes of slices 6-7, kept so a consumer of a shared root
# recognises every reserved id.
HEARTBEAT_PREFIX = "__hb__"
LEASE_PREFIX = "__lease__"
AGG_PREFIX = "__agg__"
PM_PREFIX = "__pm__"
LINEAGE_PREFIX = "__lineage__"
BASE_PREFIX = "__base__"
KV_PREFIX = "__kv__"
MIRROR_PREFIX = "__mirror__"

# consumer-side size caps of the postmortem, lineage and base-manifest
# reads (utils/flight.PM_MAX_BYTES, engine/lineage.LINEAGE_MAX_BYTES and
# serialization.BASE_MANIFEST_MAX_BYTES are the same numbers)
PM_MAX_BYTES = 1 << 20
LINEAGE_MAX_BYTES = 1 << 18
BASE_MANIFEST_MAX_BYTES = 1 << 20

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


def pm_id(role: str, node_id: str) -> str:
    """The reserved artifact id a (role, hotkey)'s postmortem bundle
    publishes under (role-qualified: one hotkey may run several roles
    against one store)."""
    return f"{PM_PREFIX}.{role}.{node_id}"


def is_pm_id(artifact_id: str) -> bool:
    return isinstance(artifact_id, str) and \
        artifact_id.startswith(PM_PREFIX + ".")


def lineage_slug(revision: str) -> str:
    """Filename/id-safe spelling of an opaque revision string, injective
    by the percent-escape rule of :func:`shard_layer_slug`."""
    return (str(revision).replace("%", "%25").replace(".", "%2E")
            .replace("/", "%2F"))


def lineage_id(revision: str) -> str:
    """The reserved artifact id of the lineage record for ``revision``:
    keyed on the resulting revision, so records are never overwritten."""
    return f"{LINEAGE_PREFIX}.{lineage_slug(revision)}"


def is_lineage_id(artifact_id: str) -> bool:
    return isinstance(artifact_id, str) and \
        artifact_id.startswith(LINEAGE_PREFIX + ".")


def base_shard_id(layer_key: str) -> str:
    """The reserved artifact id one base layer's shard travels under.
    The ``s.`` segment keeps shard ids disjoint from manifest ids: a
    revision slug holds no literal ``.``."""
    return f"{BASE_PREFIX}.s.{shard_layer_slug(layer_key)}"


def base_manifest_id(revision: str) -> str:
    """The reserved artifact id of the base manifest for ``revision``:
    a fetcher that probed ``base_revision() == R`` reads exactly R's
    shard set, and a mid-publish race degrades to the monolithic pull."""
    return f"{BASE_PREFIX}.{lineage_slug(revision)}"


def is_base_id(artifact_id: str) -> bool:
    return isinstance(artifact_id, str) and \
        artifact_id.startswith(BASE_PREFIX + ".")


def mirror_node_id(node_id: str) -> str:
    """The reserved pseudo-hotkey one mirror's base-shard replicas travel
    under (``shard_id(mirror_node_id(node), layer_key)``)."""
    return f"{MIRROR_PREFIX}.{node_id}"


def lease_id(role: str = "averager") -> str:
    """The reserved id a role's publication lease lives under."""
    return f"{LEASE_PREFIX}.{role}"


def agg_id(node_id: str) -> str:
    """The reserved id one sub-averager's partial aggregate travels
    under; every round's publish overwrites it, as a miner's delta id."""
    return f"{AGG_PREFIX}.{node_id}"


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


def _publish_own(transport, artifact_id: str, data: bytes) -> None:
    """Bytes that are this node's own artifact: ``publish_delta_raw``
    when the transport has it (a signing wrapper envelopes them), else
    ``publish_raw``."""
    pdr = getattr(transport, "publish_delta_raw", None)
    if pdr is not None:
        pdr(artifact_id, data)
        return
    transport.publish_raw(artifact_id, data)


def _fetch_capped(transport, artifact_id: str, cap: int) -> bytes | None:
    data = transport.fetch_delta_bytes(artifact_id)
    if data is not None and len(data) > cap:
        return None
    return data


def publish_postmortem(transport, role: str, node_id: str,
                       data: bytes) -> None:
    """Publish one frozen flight bundle under the reserved pm id."""
    _publish_own(transport, pm_id(role, node_id), data)


def fetch_postmortem_bytes(transport, role: str,
                           node_id: str) -> bytes | None:
    """Raw (size-capped) bundle bytes for one (role, hotkey), or None;
    validation lives in ``utils/flight.fetch_bundle``."""
    return _fetch_capped(transport, pm_id(role, node_id), PM_MAX_BYTES)


def publish_lineage(transport, revision: str, data: bytes) -> None:
    """Publish one lineage record under the reserved per-revision id."""
    _publish_own(transport, lineage_id(revision), data)


def fetch_lineage_bytes(transport, revision: str) -> bytes | None:
    """Raw (size-capped) lineage record bytes for one revision, or None;
    validation and the content-address check live in
    ``engine/lineage.fetch_record``."""
    return _fetch_capped(transport, lineage_id(revision), LINEAGE_MAX_BYTES)


def publish_base_shard(transport, layer_key: str, data: bytes) -> None:
    """Publish one base shard: the transport's own ``publish_base_shard``
    when present, else ``publish_raw`` under the reserved ``__base__.s.*``
    id. Base shards travel unsigned: the manifest pins their sha256."""
    ps = getattr(transport, "publish_base_shard", None)
    if ps is not None:
        ps(layer_key, data)
        return
    transport.publish_raw(base_shard_id(layer_key), data)


def fetch_base_shard(transport, layer_key: str) -> bytes | None:
    """One base shard's raw bytes from the origin slot (or None); callers
    verify them against the manifest hash (``engine/basedist.py``)."""
    fs = getattr(transport, "fetch_base_shard", None)
    if fs is not None:
        return fs(layer_key)
    return transport.fetch_delta_bytes(base_shard_id(layer_key))


def publish_base_manifest(transport, revision: str, data: bytes) -> None:
    """Publish one base manifest under the reserved per-revision id: the
    transport's own ``publish_base_manifest``, else ``publish_delta_raw``,
    else ``publish_raw``."""
    pbm = getattr(transport, "publish_base_manifest", None)
    if pbm is not None:
        pbm(revision, data)
        return
    _publish_own(transport, base_manifest_id(revision), data)


def fetch_base_manifest_bytes(transport, revision: str) -> bytes | None:
    """Raw (size-capped) base manifest bytes for one revision, or None.
    Absence is the negotiation signal: no manifest means the monolithic
    fetch."""
    fbm = getattr(transport, "fetch_base_manifest", None)
    data = (fbm(revision) if fbm is not None
            else transport.fetch_delta_bytes(base_manifest_id(revision)))
    if data is not None and len(data) > BASE_MANIFEST_MAX_BYTES:
        return None
    return data


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
