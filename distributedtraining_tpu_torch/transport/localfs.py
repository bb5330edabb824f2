"""Local-filesystem transport — the port of the JAX package's
``transport/localfs.py``: the same layout, atomic writes and content-hash
revisions, so a JAX role and a port role pointed at one root read what
the other wrote. (Signature envelopes are the signed transport's, a later
slice: an enveloped artifact reads as absent here.)

The reference's LocalHFManager (hf_manager.py:200-241) — a directory with
SHA-256 content-hash change detection — promoted to a first-class backend.
Multiple OS processes can run a full miner → validator → averager round
against one shared directory with no network, which is also how multi-node
topologies are exercised on a single box (SURVEY.md §4.1).

Layout:
    root/
      deltas/<miner_id>.msgpack        one artifact per miner, overwritten
                                       (a wire-v2 miner's is its manifest)
      deltas/<miner_id>.meta.json      its rider
      deltas/__shard__.<miner_id>.<layer-slug>.msgpack
                                       wire-v2 shards (transport/base.py
                                       shard_id), one per layer, each
                                       overwritten by the layer's next
                                       shard: storage stays bounded with
                                       no gc pass, as in the JAX package
      base/averaged_model.msgpack      the shared base model

Writes are atomic (tmp + rename, see serialization.save_file) so a reader
never sees a torn artifact — the reference has no such guarantee.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any

from .. import serialization as ser
from ..utils import obs
from .base import (META_MAX_BYTES, Revision, encode_delta_meta,
                   parse_delta_meta)

Params = Any

_DELTA_FMT = "%s.msgpack"
_META_FMT = "%s.meta.json"
_BASE_NAME = "averaged_model.msgpack"

def _hash_file(path: str) -> Revision:
    if not os.path.exists(path):
        return None
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_atomic(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())  # rename must never commit ahead of the data
    os.replace(tmp, path)  # readers never see a torn artifact


def _read_capped(path: str, max_bytes: int) -> bytes | None:
    try:
        if os.path.getsize(path) > max_bytes:
            return None
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


class LocalFSTransport:
    def __init__(self, root: str, *, max_bytes: int = ser.DEFAULT_MAX_BYTES):
        self.root = root
        self.max_bytes = max_bytes
        # revision-probe cache: path -> ((mtime_ns, size, ino), sha256).
        # The ingest pool probes every miner's revision every round
        # (engine/ingest.py); without this each probe re-hashes the full
        # artifact — O(model bytes) of pure I/O per miner per round for
        # files that almost never changed. The stat signature includes
        # the inode because _write_atomic's rename always lands a fresh
        # one, so an overwrite inside mtime granularity still misses.
        self._rev_cache: dict[str, tuple[tuple, str]] = {}
        os.makedirs(os.path.join(root, "deltas"), exist_ok=True)
        os.makedirs(os.path.join(root, "base"), exist_ok=True)

    def _revision_of(self, path: str) -> Revision:
        try:
            st = os.stat(path)
        except OSError:
            return None
        sig = (st.st_mtime_ns, st.st_size, st.st_ino)
        hit = self._rev_cache.get(path)
        if hit is not None and hit[0] == sig:
            return hit[1]
        obs.count("transport.revision_hash")
        h = _hash_file(path)
        if h is not None:
            self._rev_cache[path] = (sig, h)
        return h

    @staticmethod
    def _safe_id(miner_id: str) -> str:
        """One sanitizer for every per-miner path: the artifact and its
        rider must always map to the SAME identity."""
        return miner_id.replace("/", "_").replace("..", "_")

    def _delta_path(self, miner_id: str) -> str:
        return os.path.join(self.root, "deltas",
                            _DELTA_FMT % self._safe_id(miner_id))

    @property
    def _base_path(self) -> str:
        return os.path.join(self.root, "base", _BASE_NAME)

    # -- miner side ---------------------------------------------------------
    def publish_delta(self, miner_id: str, delta: Params) -> Revision:
        # transport spans inherit the thread's correlation id
        with obs.span("transport.publish_delta"):
            path = self._delta_path(miner_id)
            ser.save_file(delta, path)
            return self._revision_of(path)

    def publish_raw(self, miner_id: str, data: bytes) -> Revision:
        """Arbitrary (possibly hostile) bytes as a 'delta'."""
        path = self._delta_path(miner_id)
        _write_atomic(path, data)
        return self._revision_of(path)

    # -- validator / averager side -----------------------------------------
    def fetch_delta(self, miner_id: str, template: Params) -> Params | None:
        with obs.span("transport.fetch_delta"):
            data = self.fetch_delta_bytes(miner_id)
            if data is None:
                return None
            try:
                return ser.from_msgpack(data, template,
                                        max_bytes=self.max_bytes)
            except ser.PayloadError:
                return None

    def fetch_delta_bytes(self, miner_id: str) -> bytes | None:
        """Raw artifact bytes (size-capped), one read."""
        return _read_capped(self._delta_path(miner_id), self.max_bytes)

    def delta_revision(self, miner_id: str) -> Revision:
        return self._revision_of(self._delta_path(miner_id))

    def _meta_path(self, miner_id: str) -> str:
        return os.path.join(self.root, "deltas",
                            _META_FMT % self._safe_id(miner_id))

    def publish_delta_meta(self, miner_id: str, meta: dict) -> None:
        _write_atomic(self._meta_path(miner_id), encode_delta_meta(meta))

    def fetch_delta_meta(self, miner_id: str) -> dict | None:
        return parse_delta_meta(
            _read_capped(self._meta_path(miner_id), META_MAX_BYTES))

    # -- base model ---------------------------------------------------------
    def publish_base(self, base: Params) -> Revision:
        with obs.span("transport.publish_base"):
            ser.save_file(base, self._base_path)
            return self._revision_of(self._base_path)

    def publish_base_raw(self, data: bytes) -> Revision:
        """Pre-serialized base bytes."""
        _write_atomic(self._base_path, data)
        return self._revision_of(self._base_path)

    def fetch_base_bytes(self) -> bytes | None:
        return _read_capped(self._base_path, self.max_bytes)

    def fetch_base(self, template: Params):
        with obs.span("transport.fetch_base"):
            data = self.fetch_base_bytes()
            if data is None:
                return None
            try:
                tree = ser.from_msgpack(data, template,
                                        max_bytes=self.max_bytes)
            except ser.PayloadError:
                # a torn/corrupt base reads as "absent", never a crash
                return None
            return tree, self._revision_of(self._base_path)

    def base_revision(self) -> Revision:
        return self._revision_of(self._base_path)

    def gc(self) -> None:
        pass  # overwrite-in-place layout never accumulates history
