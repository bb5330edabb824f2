"""Content-addressed base distribution — the port of the JAX package's
``engine/basedist.py`` (``base_layer_items``, ``assemble_base_tree``,
``BaseShardStore``, ``BasePublisher``, ``read_base_wire_rider``,
``BaseFetcher``, ``MirrorDuty``).

- :class:`BasePublisher`: after the averager's monolithic
  ``publish_base`` (still the source of truth, and the fallback of every
  fetcher that does not read manifests), the base goes out as one
  hash-addressed shard a wire-layout leaf (``__base__.s.<slug>``, only
  changed hashes re-upload), then one manifest under the per-revision
  ``__base__.<revision>`` id, manifest last, then a ``{"base_wire": ...}``
  rider on the stable ``__base__`` id that announces the plane and its
  mirrors.
- :class:`BaseFetcher`: a miner or validator diffs the manifest of the
  revision it probed against its content-addressed
  :class:`BaseShardStore` and fetches only the layers whose hash it does
  not hold, from the announced and configured mirrors first (rotating,
  with per-replica strikes counted in shard attempts), then the origin,
  checking every shard against the manifest's sha256. Any failure of the
  sharded path (no, a hostile or a torn manifest, an unreachable shard, a
  shape or dtype that does not match) falls back to the monolithic pull,
  and a monolithic fetch seeds the store: the shard encoding is
  deterministic in the array bytes, so the digests the fetcher derives
  match the publisher's.

Shard, manifest and rider bytes equal the JAX package's for the same
tree, so either package's publisher feeds either package's fetcher. The
layer keys are the ``/``-joined wire paths (a state dict's ``.``-joined
keys with ``.`` read as ``/``). Fetched layers are host arrays; the role
places the assembled tree on the card once, as it places a monolithic
pull. A signed averager's manifest is enveloped (``transport/signed.py``
verifies it; a plain transport's reader strips the envelope unverified,
as in the JAX package). :class:`MirrorDuty` is a sub-averager's
(``--hier sub``) replica writer: it copies the current revision's shard
bytes, never decoded, under its ``__mirror__.<node>`` slots, then the
presence rider.

Registry metrics (the ``base.*`` family, as in the JAX package): publish
side ``base.shards_uploaded``, ``base.shards_skipped``,
``base.bytes_published``, ``base.manifest_publishes``,
``base.publish_failures``; fetch side ``base.bytes_fetched``,
``base.shards_fetched``, ``base.shards_deduped``, ``base.mirror_hits``,
``base.mirror_bytes``, ``base.origin_bytes``, ``base.replica_misses``,
``base.torn_fetches``, ``base.manifest_rejects``,
``base.monolithic_fallbacks``, ``base.sharded_fetches`` and the
``base.fetch_ms`` histogram.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch

from .. import serialization as ser
from ..delta import _dtype_name, _walk_state_dict
from ..transport import base as tbase
from ..utils import flight, obs

logger = logging.getLogger(__name__)

Params = Any

# a replica with this many consecutive failures is skipped for the next
# STRIKE_COOLDOWN shard attempts (backoff counted in operations, not time)
REPLICA_STRIKES = 2
STRIKE_COOLDOWN = 16

DEFAULT_STORE_BYTES = 1 << 30


def _parse_manifest(data) -> dict | None:
    """A base manifest's fields from fetched bytes, a signature envelope
    stripped unverified (a signed transport already verified it)."""
    from .. import signing
    try:
        return ser.parse_base_manifest(signing.strip_envelope(bytes(data)))
    except ser.PayloadError:
        return None


def _is_nested(tree: Mapping) -> bool:
    return any(isinstance(v, Mapping) for v in tree.values())


def _leaf_paths(tree: Mapping) -> Iterator[tuple[str, tuple, Any]]:
    """``(layer key, path, leaf)`` of a nested wire tree (path = its
    keys) or of a flat state dict (path = the one ``.``-joined key)."""
    if _is_nested(tree):
        for path, leaf in _walk_state_dict(tree):
            yield "/".join(path), path, leaf
    else:
        for k, leaf in tree.items():
            yield str(k).replace(".", "/"), (k,), leaf


def _host(leaf):
    """A leaf as host data: a numpy array, or a CPU tensor for bf16
    (numpy has no bf16 on the card machine)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(leaf)


def base_layer_items(tree: Mapping) -> dict[str, Any]:
    """A wire-layout base (a nested tree, or a state dict) as its shard
    units: one ``"a/b/c" -> host array`` a leaf, keyed by the ``/``-joined
    wire path the base manifest addresses. Publisher-side, on its own
    tree: a path component holding ``/`` raises instead of giving
    ambiguous keys."""
    out: dict[str, Any] = {}
    for key, path, leaf in _leaf_paths(tree):
        if _is_nested(tree) and any("/" in p for p in path):
            raise ValueError(f"base_layer_items: path component with '/' "
                             f"in {path!r} would make layer keys "
                             "ambiguous")
        out[key] = _host(leaf)
    return out


def assemble_base_tree(entries: Mapping[str, Any],
                       template: Mapping) -> Params | None:
    """Inverse of :func:`base_layer_items` against a trusted template:
    fetched layers in the template's structure (nested, or a flat state
    dict), each leaf's shape AND dtype checked (the base's dtype is the
    contract). None on any mismatch."""
    nested = _is_nested(template)
    out: dict = {}
    for key, path, tmpl in _leaf_paths(template):
        arr = entries.get(key)
        if arr is None:
            return None
        if (tuple(arr.shape) != tuple(tmpl.shape)
                or _dtype_name(arr) != _dtype_name(tmpl)):
            return None
        if not nested:
            out[path[0]] = arr
            continue
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return out


class BaseShardStore:
    """LRU host store of base layers keyed by shard CONTENT hash, within
    a byte budget (thread-safe). It holds decoded arrays, so a warm
    round's unchanged layers cost nothing to assemble."""

    def __init__(self, max_bytes: int = DEFAULT_STORE_BYTES):
        self.max_bytes = max(0, int(max_bytes))
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, tuple[Any, int]] = OrderedDict()
        self._bytes = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, digest: str):
        if self.max_bytes <= 0 or not isinstance(digest, str):
            return None
        with self._lock:
            hit = self._entries.get(digest)
            if hit is None:
                return None
            self._entries.move_to_end(digest)
            return hit[0]

    def put(self, digest: str, arr) -> None:
        if self.max_bytes <= 0 or not isinstance(digest, str):
            return
        nb = ser._nbytes(arr)
        if nb > self.max_bytes:
            return
        with self._lock:
            old = self._entries.pop(digest, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[digest] = (arr, nb)
            self._bytes += nb
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, (_, ev_nb) = self._entries.popitem(last=False)
                self._bytes -= ev_nb



# ---------------------------------------------------------------------------
# Publisher (averager side)
# ---------------------------------------------------------------------------

class BasePublisher:
    """The averager's shard-plane publication. ``publish_revision(tree,
    revision)`` runs after the monolithic ``publish_base`` landed
    ``revision``: encode and hash every layer, upload the shards whose
    hash changed since the last confirmed publish, then the manifest,
    then the announce rider. ``_last_shards`` advances only once the
    manifest lands, so a failed publish re-uploads everything unconfirmed
    next round. A failure degrades the shard plane, never the round.
    ``mirrors`` names the mirror nodes the rider advertises."""

    def __init__(self, transport, *, mirrors: Sequence[str] = ()):
        self.transport = transport
        self.mirrors = [str(m) for m in mirrors]
        # layer key -> sha256 of the last shard set the fleet can see
        self._last_shards: dict[str, str] = {}
        # shards uploaded and skipped, and bytes, of the last commit
        self.last_publish: dict | None = None

    def publish_revision(self, tree: Mapping, revision: str) -> bool:
        """Publish ``tree``'s shard set and manifest for the landed
        monolithic ``revision``; True when the manifest committed, False
        (logged and counted) on any failure. Each layer is hashed from
        its encoding's pieces and packed only when it uploads, so the
        publish holds one shard's bytes at a time (an 8B base's 32 GB
        would otherwise be held twice)."""
        from ..transport.retry import DEFAULT_PUBLISH_RETRY, call_with_retry
        try:
            entries = base_layer_items(tree)
            layers = {k: ser.base_shard_digest(a) for k, a in entries.items()}
            manifest = ser.build_base_manifest(layers, revision=revision)
        except Exception:
            obs.count("base.publish_failures")
            logger.exception("base publisher: shard encode failed; "
                             "fetchers stay on the monolithic base")
            return False
        changed = [k for k, (digest, _) in layers.items()
                   if self._last_shards.get(k) != digest]
        shards_done = 0
        try:
            for key in changed:
                data = ser.pack_base_shard(entries[key])
                call_with_retry(
                    lambda key=key, data=data: tbase.publish_base_shard(
                        self.transport, key, data),
                    policy=DEFAULT_PUBLISH_RETRY,
                    describe=f"base shard {key}")
                obs.count("base.bytes_published", len(data))
                shards_done += 1
            obs.count("base.shards_uploaded", len(changed))
            obs.count("base.shards_skipped", len(layers) - len(changed))
            call_with_retry(
                lambda: tbase.publish_base_manifest(
                    self.transport, revision, manifest),
                policy=DEFAULT_PUBLISH_RETRY,
                describe="base manifest publish")
        except Exception:
            # a torn shard set: no manifest names it, so fetchers stay on
            # the monolithic base; the flight ring names the tear
            obs.count("base.publish_failures")
            flight.record("publish", outcome="torn",
                          hotkey=tbase.BASE_PREFIX,
                          cid=obs.current_cid() or "",
                          shards_done=shards_done,
                          shards_total=len(changed), manifest=False)
            logger.exception("base publisher: sharded publish failed "
                             "(monolithic base already out)")
            return False
        obs.count("base.bytes_published", len(manifest))
        obs.count("base.manifest_publishes")
        self._last_shards = {k: digest for k, (digest, _) in layers.items()}
        self.last_publish = {"shards_uploaded": len(changed),
                             "shards_skipped": len(layers) - len(changed),
                             "bytes": sum(layers[k][1] for k in changed)
                             + len(manifest)}
        flight.record("publish", outcome="ok", hotkey=tbase.BASE_PREFIX,
                      cid=obs.current_cid() or "", wire="base")
        self._announce(revision)
        return True

    def _announce(self, revision: str) -> None:
        """The base-wire declaration rider on the stable ``__base__`` id,
        after the manifest it names (best effort)."""
        pm = getattr(self.transport, "publish_delta_meta", None)
        if pm is None:
            return
        try:
            pm(tbase.BASE_PREFIX,
               {"base_wire": {"format": 1, "revision": revision,
                              "mirrors": self.mirrors}})
        except Exception:
            logger.warning("base publisher: announce rider failed; "
                           "fetchers discover the manifest by probe",
                           exc_info=True)


def fetch_base(transport, fetcher, template: Mapping, revision=None):
    """A role's base pull: through ``fetcher`` (a :class:`BaseFetcher`,
    only the changed layers, the monolithic fallback inside) when one is
    wired, else the monolithic pull. A torn or hostile read returns
    None."""
    if fetcher is not None:
        return fetcher.fetch(template, revision=revision)
    return transport.fetch_base(template)


def read_base_wire_rider(transport) -> dict | None:
    """Defensive read of the averager's base-wire declaration:
    ``{"revision": str, "mirrors": [str, ...]}`` or None (anything
    malformed reads as absent, never an exception)."""
    fm = getattr(transport, "fetch_delta_meta", None)
    if fm is None:
        return None
    try:
        meta = fm(tbase.BASE_PREFIX)
    except Exception:
        return None
    if not isinstance(meta, dict):
        return None
    bw = meta.get("base_wire")
    if not isinstance(bw, dict) or bw.get("format") != 1:
        return None
    rev = bw.get("revision")
    if not (isinstance(rev, str) and 0 < len(rev) <= 200):
        return None
    mirrors = bw.get("mirrors")
    out_mirrors = []
    if isinstance(mirrors, list):
        for m in mirrors[:64]:
            if isinstance(m, str) and 0 < len(m) <= 200:
                out_mirrors.append(m)
    return {"revision": rev, "mirrors": out_mirrors}


# ---------------------------------------------------------------------------
# Fetcher (miner / validator side)
# ---------------------------------------------------------------------------

class BaseFetcher:
    """Delta-pull base fetches with mirror racing and the monolithic
    fallback; one long-lived instance a role (the store and the strike
    ledger live across rounds). ``mirrors`` are configured mirror nodes;
    the announce rider's list is put first at fetch time. ``fetch`` never
    raises: a failure degrades to the monolithic pull, then to None ("no
    new base")."""

    def __init__(self, transport, *, store_bytes: int = DEFAULT_STORE_BYTES,
                 mirrors: Sequence[str] = ()):
        self.transport = transport
        self.store = BaseShardStore(store_bytes)
        self.mirrors = [str(m) for m in mirrors]
        self._strikes: dict[str, int] = {}
        self._cooldown: dict[str, int] = {}
        self._rotate = 0
        self._lock = threading.Lock()
        # lifetime stats
        self.bytes_fetched_total = 0
        self.mirror_hits_total = 0
        self.network_shards_total = 0
        self.shard_lookups_total = 0
        self.store_hits_total = 0
        self.last_fetch_bytes = 0
        self.fallbacks_total = 0
        self.sharded_fetches_total = 0

    # -- replica bookkeeping -------------------------------------------------
    def _replica_ok(self, node: str) -> None:
        with self._lock:
            self._strikes.pop(node, None)
            self._cooldown.pop(node, None)

    def _replica_failed(self, node: str) -> None:
        with self._lock:
            s = self._strikes.get(node, 0) + 1
            self._strikes[node] = s
            if s >= REPLICA_STRIKES:
                self._cooldown[node] = STRIKE_COOLDOWN

    def _skip(self, node: str) -> bool:
        """Consume one cooldown tick; True while the replica is benched."""
        with self._lock:
            left = self._cooldown.get(node, 0)
            if left <= 0:
                return False
            self._cooldown[node] = left - 1
            if self._cooldown[node] <= 0:
                del self._cooldown[node]
                self._strikes.pop(node, None)
            return True

    def _replica_order(self, rider: dict | None) -> list[str]:
        """Mirror order for this fetch: advertised mirrors before
        configured-only ones, rotated a fetch so a fleet spreads across
        replicas."""
        advertised = list((rider or {}).get("mirrors") or ())
        rest = [m for m in self.mirrors if m not in advertised]
        order = advertised + rest
        if len(order) > 1:
            with self._lock:
                self._rotate = (self._rotate + 1) % len(order)
                r = self._rotate
            order = order[r:] + order[:r]
        return order

    # -- the fetch -----------------------------------------------------------
    def fetch(self, template: Mapping, revision: str | None = None
              ) -> tuple[Params, str | None] | None:
        """The current base: the sharded pull when a manifest exists for
        the probed revision, else the monolithic pull. ``(tree in the
        template's structure, revision)`` or None."""
        t0 = time.perf_counter()
        rev = revision
        if rev is None:
            try:
                rev = self.transport.base_revision()
            except Exception:
                logger.warning("base fetch: revision probe failed",
                               exc_info=True)
                return None
        if rev is None:
            return None
        self.last_fetch_bytes = 0
        got = self._fetch_sharded(template, rev)
        if got is None:
            got = self._fetch_monolithic(template, rev)
        if got is not None:
            obs.observe("base.fetch_ms", (time.perf_counter() - t0) * 1e3)
        return got

    def seed(self, tree: Mapping) -> None:
        """Warm the store from a base obtained out of band (a restored
        checkpoint, a monolithic fetch): each layer packed locally."""
        try:
            for arr in base_layer_items(tree).values():
                self.store.put(ser.base_shard_digest(arr)[0], arr)
        except Exception:
            logger.warning("base fetch: store seeding failed",
                           exc_info=True)

    # -- sharded path --------------------------------------------------------
    def _fetch_sharded(self, template: Mapping, rev: str):
        try:
            data = tbase.fetch_base_manifest_bytes(self.transport, rev)
        except Exception:
            obs.count("base.replica_misses")
            return None
        if data is None:
            return None   # an older averager, or mid-publish: monolithic
        self.last_fetch_bytes += len(data)
        self.bytes_fetched_total += len(data)
        obs.count("base.bytes_fetched", len(data))
        obs.count("base.origin_bytes", len(data))
        man = _parse_manifest(data)
        if man is None or man["revision"] != rev:
            obs.count("base.manifest_rejects")
            logger.warning("base fetch: manifest for %s rejected "
                           "(hostile or torn); falling back to the "
                           "monolithic base", rev and rev[:8])
            return None
        replicas = self._replica_order(read_base_wire_rider(self.transport))
        entries: dict[str, Any] = {}
        for key, info in man["layers"].items():
            self.shard_lookups_total += 1
            cached = self.store.lookup(info["h"])
            if cached is not None:
                obs.count("base.shards_deduped")
                self.store_hits_total += 1
                entries[key] = cached
                continue
            arr = self._fetch_shard(key, info["h"], replicas)
            if arr is None:
                return None
            entries[key] = arr
        tree = assemble_base_tree(entries, template)
        if tree is None:
            obs.count("base.manifest_rejects")
            logger.warning("base fetch: shard set for %s does not match "
                           "the template; falling back", rev and rev[:8])
            return None
        obs.count("base.sharded_fetches")
        self.sharded_fetches_total += 1
        return tree, rev

    def _take(self, data: bytes, digest: str, *, mirror: bool):
        """A fetched shard's bytes checked and decoded (None when they
        fail the manifest's hash or do not parse)."""
        if ser.shard_digest(data) != digest:
            obs.count("base.torn_fetches")
            return None
        arr = ser.unpack_base_shard(data)
        if arr is None:
            return None
        n = len(data)
        self.last_fetch_bytes += n
        self.bytes_fetched_total += n
        self.network_shards_total += 1
        obs.count("base.bytes_fetched", n)
        obs.count("base.shards_fetched")
        if mirror:
            self.mirror_hits_total += 1
            obs.count("base.mirror_bytes", n)
            obs.count("base.mirror_hits")
        else:
            obs.count("base.origin_bytes", n)
        self.store.put(digest, arr)
        return arr

    def _fetch_shard(self, key: str, digest: str, replicas: list[str]):
        """One shard from any replica that holds the hash: mirrors in
        order, then the origin; every payload is checked against the
        manifest digest, whichever slot served it."""
        for node in replicas:
            if self._skip(node):
                continue
            try:
                data = tbase.fetch_shard(
                    self.transport, tbase.mirror_node_id(node), key)
            except Exception:
                data = None
            arr = (self._take(data, digest, mirror=True)
                   if data is not None else None)
            if arr is None:
                obs.count("base.replica_misses")
                self._replica_failed(node)
                continue
            self._replica_ok(node)
            return arr
        try:
            data = tbase.fetch_base_shard(self.transport, key)
        except Exception:
            data = None
        arr = (self._take(data, digest, mirror=False)
               if data is not None else None)
        if arr is None:
            obs.count("base.replica_misses")
        return arr

    # -- monolithic fallback -------------------------------------------------
    def _fetch_monolithic(self, template: Mapping, rev: str):
        obs.count("base.monolithic_fallbacks")
        self.fallbacks_total += 1
        try:
            got = self.transport.fetch_base(template)
        except Exception:
            logger.warning("base fetch: monolithic pull failed",
                           exc_info=True)
            return None
        if got is None:
            return None
        tree, fetched_rev = got
        nb = sum(ser._nbytes(leaf) for _, _, leaf in _leaf_paths(tree))
        self.last_fetch_bytes += nb
        self.bytes_fetched_total += nb
        obs.count("base.bytes_fetched", nb)
        obs.count("base.origin_bytes", nb)
        # the next round's sharded pull then fetches only what moved
        self.seed(tree)
        return tree, fetched_rev

    # -- heartbeat extras ----------------------------------------------------
    def heartbeat_fields(self) -> dict:
        """Numeric extras for the role's heartbeat: lifetime fetched
        bytes, the last pull's bytes, the store's dedupe rate (of the
        layers looked up, the share that cost no bytes) and the mirror
        hit rate (of the shards fetched over the network, the share a
        mirror served)."""
        out = {"base_fetch_bytes": float(self.bytes_fetched_total),
               "base_last_fetch_bytes": float(self.last_fetch_bytes)}
        if self.shard_lookups_total:
            out["base_dedupe_hit_rate"] = (
                self.store_hits_total / self.shard_lookups_total)
        if self.network_shards_total:
            out["base_mirror_hit_rate"] = (
                self.mirror_hits_total / self.network_shards_total)
        return out


# ---------------------------------------------------------------------------
# Mirror duty (sub-averager side)
# ---------------------------------------------------------------------------

class MirrorDuty:
    """Regional shard replication for one ``__agg__`` node: read the
    current base manifest, fetch from the origin only the shards whose
    hash this node has not replicated yet, publish them again under the
    node's ``__mirror__.<node>`` shard slots, then the presence rider
    naming the mirrored revision — rider last, as manifests are, so a
    fetcher that reads the rider finds the shards in place. Bytes only:
    a shard is hash-checked and never decoded (fetchers check it again).

    ``sync()`` is isolated by its caller (a failed pass is a non-event)
    and cheap when nothing changed: one revision probe, no shard traffic.
    ``last_sync`` holds the last pass's ``{"shards", "bytes"}``."""

    def __init__(self, transport, node_id: str):
        self.transport = transport
        self.node_id = node_id
        self._mirrored: dict[str, str] = {}   # layer_key -> digest
        self._last_revision: str | None = None
        self.last_sync: dict | None = None

    def sync(self) -> bool:
        """One replication pass; True when this node now mirrors the
        current revision's whole shard set."""
        try:
            rev = self.transport.base_revision()
        except Exception:
            return False
        if rev is None:
            return False
        if rev == self._last_revision:
            obs.count("base.mirror_rounds")
            self.last_sync = {"shards": 0, "bytes": 0}
            return True
        try:
            data = tbase.fetch_base_manifest_bytes(self.transport, rev)
        except Exception:
            return False
        if data is None:
            return False   # a monolithic-only averager: nothing to mirror
        man = _parse_manifest(data)
        if man is None or man["revision"] != rev:
            obs.count("base.manifest_rejects")
            return False
        synced = nbytes = 0
        for key, info in man["layers"].items():
            if self._mirrored.get(key) == info["h"]:
                continue
            try:
                shard = tbase.fetch_base_shard(self.transport, key)
            except Exception:
                return False
            if shard is None or ser.shard_digest(shard) != info["h"]:
                obs.count("base.torn_fetches")
                return False   # a mid-publish race: the next sync heals it
            try:
                tbase.publish_shard(
                    self.transport, tbase.mirror_node_id(self.node_id),
                    key, shard)
            except Exception as e:
                logger.warning("mirror %s: shard republish failed: %s",
                               self.node_id, e)
                return False
            obs.count("base.mirror_sync_bytes", len(shard))
            self._mirrored[key] = info["h"]
            synced += 1
            nbytes += len(shard)
        # drop layers the manifest no longer names (a model-shape change)
        for key in list(self._mirrored):
            if key not in man["layers"]:
                del self._mirrored[key]
        self._last_revision = rev
        self.last_sync = {"shards": synced, "bytes": nbytes}
        obs.count("base.mirror_publishes", synced)
        obs.count("base.mirror_rounds")
        pm = getattr(self.transport, "publish_delta_meta", None)
        if pm is not None:
            try:
                pm(tbase.mirror_node_id(self.node_id),
                   {"mirror": {"revision": rev,
                               "layers": len(man["layers"])}})
            except Exception:
                logger.debug("mirror %s: presence rider failed",
                             self.node_id, exc_info=True)
        return True
