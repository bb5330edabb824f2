"""Content-addressed KV page transfer for disaggregated serving — the port
of the JAX package's ``engine/kv_transfer.py``.

A PREFILL worker (``GenerationEngine(phase="prefill")``) runs a request's
prompt, exports its KV pages and finishes; a DECODE worker
(``phase="decode"``) adopts those pages into its own pool and decodes.
This module is the plane between them.

- The wire unit is one page of the pool: the ``[L, P, Hkv, D]`` slice of
  the ``[L, pages, P, Hkv, D]`` pool, K and V together, as the msgpack
  tree ``{"k", "v"}`` (``serialization.to_msgpack``: flax's bytes, so a
  page's sha256 is the same in both packages).
- Pages publish first as ``__kv__.s.<sha256>``, the per-request manifest
  (``__kv__.<request-slug>``: page digests in page-table order, the
  geometry, the base revision, the prompt length and the first token)
  LAST, so a reader that can decode a manifest sees a complete page set
  or takes a hash miss.
- Every fetched page is hashed again and checked against the manifest.
  Any defect (absent or torn manifest, hash miss, bad page) returns None,
  and the decode worker prefills locally, counted.

Two prompts sharing a prefix export identical full pages: the exporter
publishes each digest once a session, and the adopter's
:class:`KVPageStore` serves repeats without touching the wire.
"""

from __future__ import annotations

import json
import logging
import time
from collections import OrderedDict

import numpy as np
import torch

from .. import serialization as ser
from ..transport import base as tbase
from ..utils import obs

logger = logging.getLogger(__name__)

# not valid msgpack: a reader that lands on other bytes rejects at the
# magic instead of mis-parsing them
KV_MANIFEST_MAGIC = b"DTKV1\n"

KV_MANIFEST_MAX_BYTES = tbase.KV_MANIFEST_MAX_BYTES
KV_PAGE_MAX_BYTES = tbase.KV_PAGE_MAX_BYTES

# pages a manifest may list (bounds a hostile manifest's fan-out)
KV_MAX_PAGES = 4096


def dtype_name(x) -> str:
    """The dtype string a manifest carries: numpy's name (``"float32"``,
    ``"bfloat16"``), also for a torch tensor (not ``"torch.float32"``)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


# ---------------------------------------------------------------------------
# Page codec
# ---------------------------------------------------------------------------

def pack_kv_page(k_page, v_page) -> bytes:
    """One page's wire bytes: K and V ``[L, P, Hkv, D]`` (CPU tensors or
    arrays) as the msgpack tree ``{"k", "v"}``."""
    return ser.to_msgpack({"k": k_page, "v": v_page})


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))    # a writable copy of the buffer


def unpack_kv_page(data: bytes, *, max_bytes: int = KV_PAGE_MAX_BYTES):
    """Decode one page's bytes to ``(k, v)`` CPU tensors, or None on any
    defect (oversize, bad msgpack, wrong keys, K/V shape or dtype skew,
    wrong rank). Agreement with the adopting pool is the engine's check."""
    if not isinstance(data, (bytes, bytearray)) or len(data) > max_bytes:
        return None
    try:
        raw = ser.from_msgpack(bytes(data), None, max_bytes=max_bytes)
    except ser.PayloadError:
        return None
    if not isinstance(raw, dict) or set(raw) != {"k", "v"}:
        return None
    k, v = raw["k"], raw["v"]
    if not all(isinstance(x, (np.ndarray, torch.Tensor)) for x in (k, v)):
        return None
    if tuple(k.shape) != tuple(v.shape) or dtype_name(k) != dtype_name(v) \
            or k.ndim != 4:
        return None
    return _as_tensor(k), _as_tensor(v)


# ---------------------------------------------------------------------------
# Manifest codec
# ---------------------------------------------------------------------------

def build_kv_manifest(*, request_id: str, revision: str,
                      pages: list[tuple[str, int]],
                      geometry: dict, prompt_len: int,
                      first_token: int) -> bytes:
    """Canonical manifest bytes for one request's exported KV.

    ``pages`` is ``[(sha256 hex, nbytes), ...]`` in page-table order (page
    i holds prompt rows ``i*P .. (i+1)*P``); ``geometry`` is the adopting
    pool's contract (layers, page_size, kv_heads, head_dim, dtype);
    ``revision`` the base revision the pages were prefilled on;
    ``first_token`` the prefill worker's first token, which the decode
    worker emits verbatim."""
    body = {
        "format": 1,
        "request_id": str(request_id),
        "revision": str(revision),
        "prompt_len": int(prompt_len),
        "first_token": int(first_token),
        "geometry": {k: (str(v) if k == "dtype" else int(v))
                     for k, v in geometry.items()},
        "pages": [{"h": h, "n": int(n)} for h, n in pages],
    }
    data = KV_MANIFEST_MAGIC + json.dumps(
        body, sort_keys=True, separators=(",", ":")).encode()
    if len(data) > KV_MANIFEST_MAX_BYTES:
        raise ValueError(
            f"kv manifest {len(data)}B exceeds cap {KV_MANIFEST_MAX_BYTES}B")
    return data


_HEX = set("0123456789abcdef")
_GEOM_KEYS = ("layers", "page_size", "kv_heads", "head_dim", "dtype")


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def parse_kv_manifest(data: bytes) -> dict | None:
    """Decode and validate manifest bytes, or None on any defect (bad
    magic, oversize, not JSON, wrong format, malformed digests, absurd
    sizes or counts): a defect means no transfer, never an exception."""
    if not isinstance(data, (bytes, bytearray)):
        return None
    data = bytes(data)
    if not data.startswith(KV_MANIFEST_MAGIC) or \
            len(data) > KV_MANIFEST_MAX_BYTES:
        return None
    try:
        body = json.loads(data[len(KV_MANIFEST_MAGIC):])
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(body, dict) or body.get("format") != 1:
        return None
    rid, rev = body.get("request_id"), body.get("revision")
    if not (isinstance(rid, str) and 0 < len(rid) <= 200):
        return None
    if not (isinstance(rev, str) and len(rev) <= 200):
        return None
    plen, first = body.get("prompt_len"), body.get("first_token")
    if not (_is_int(plen) and plen > 0 and _is_int(first) and first >= 0):
        return None
    geom = body.get("geometry")
    if not (isinstance(geom, dict) and set(geom) == set(_GEOM_KEYS)):
        return None
    for k in _GEOM_KEYS:
        v = geom[k]
        if k == "dtype":
            if not (isinstance(v, str) and 0 < len(v) <= 32):
                return None
        elif not (_is_int(v) and 0 < v <= 1 << 20):
            return None
    pages = body.get("pages")
    if not (isinstance(pages, list) and 0 < len(pages) <= KV_MAX_PAGES):
        return None
    out_pages: list[tuple[str, int]] = []
    for ent in pages:
        if not (isinstance(ent, dict) and set(ent) == {"h", "n"}):
            return None
        h, n = ent["h"], ent["n"]
        if not (isinstance(h, str) and len(h) == 64 and set(h) <= _HEX):
            return None
        if not (_is_int(n) and 0 < n <= KV_PAGE_MAX_BYTES):
            return None
        out_pages.append((h, n))
    return {"request_id": rid, "revision": rev, "prompt_len": plen,
            "first_token": first, "geometry": dict(geom),
            "pages": out_pages}


# ---------------------------------------------------------------------------
# Adopter-side page store
# ---------------------------------------------------------------------------

DEFAULT_STORE_BYTES = 64 << 20


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class KVPageStore:
    """Content-addressed LRU over verified ``(k, v)`` page pairs, bounded
    by ``max_bytes`` (the newest entry always stays)."""

    def __init__(self, max_bytes: int = DEFAULT_STORE_BYTES):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_bytes = max_bytes
        self._entries: OrderedDict[str, tuple] = OrderedDict()
        self._nbytes = 0

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, digest: str):
        ent = self._entries.get(digest)
        if ent is not None:
            self._entries.move_to_end(digest)
        return ent

    def put(self, digest: str, k: torch.Tensor, v: torch.Tensor) -> None:
        if digest in self._entries:
            self._entries.move_to_end(digest)
            return
        self._entries[digest] = (k, v)
        self._nbytes += _nbytes(k) + _nbytes(v)
        while self._nbytes > self.max_bytes and len(self._entries) > 1:
            _, (ok, ov) = self._entries.popitem(last=False)
            self._nbytes -= _nbytes(ok) + _nbytes(ov)

    def clear(self) -> None:
        self._entries.clear()
        self._nbytes = 0


# ---------------------------------------------------------------------------
# Exporter (prefill worker), adopter fetch (decode worker)
# ---------------------------------------------------------------------------

class KVExporter:
    """Prefill-worker side: publish one request's KV pages as
    content-addressed shards, then its manifest. A digest published
    once this session is not sent again (``serve.kv_pages_deduped``)."""

    def __init__(self, transport):
        self.transport = transport
        self._published: set[str] = set()
        self.exports = 0
        self.bytes_published = 0

    def export(self, *, request_id: str, revision: str, pages,
               prompt_len: int, first_token: int, page_size: int) -> bool:
        """Publish ``pages`` (``(k, v)`` CPU pairs in page-table order)
        and the manifest. False leaves no readable manifest, so the
        decode side prefills locally."""
        t0 = time.perf_counter()
        try:
            entries: list[tuple[str, int]] = []
            for k, v in pages:
                data = pack_kv_page(k, v)
                digest = ser.shard_digest(data)
                entries.append((digest, len(data)))
                if digest in self._published:
                    obs.count("serve.kv_pages_deduped")
                    continue
                tbase.publish_kv_page(self.transport, digest, data)
                self._published.add(digest)
                self.bytes_published += len(data)
                obs.count("serve.kv_export_bytes", len(data))
            k0 = pages[0][0]
            manifest = build_kv_manifest(
                request_id=request_id, revision=revision or "",
                pages=entries,
                geometry={"layers": k0.shape[0], "page_size": page_size,
                          "kv_heads": k0.shape[2], "head_dim": k0.shape[3],
                          "dtype": dtype_name(k0)},
                prompt_len=prompt_len, first_token=first_token)
            tbase.publish_kv_manifest(self.transport, request_id, manifest)
            self.bytes_published += len(manifest)
            obs.count("serve.kv_export_bytes", len(manifest))
        except Exception:
            logger.exception("kv export failed for request %s", request_id)
            obs.count("serve.kv_export_failures")
            return False
        self.exports += 1
        obs.count("serve.kv_exports")
        obs.count("serve.kv_pages_exported", len(pages))
        obs.observe("serve.kv_export_ms", (time.perf_counter() - t0) * 1e3)
        return True


class KVAdopter:
    """Decode-worker side: fetch and verify one request's exported KV.

    :meth:`fetch` returns the parsed manifest with ``pages`` replaced by
    verified ``(k, v)`` CPU tensor pairs, or None on any transfer defect.
    Revision and geometry agreement are the engine's checks (it counts a
    revision skew apart from a transfer fault)."""

    def __init__(self, transport, *, store: KVPageStore | None = None):
        self.transport = transport
        self.store = store if store is not None else KVPageStore()
        self.adoptions = 0
        self.bytes_fetched = 0

    def fetch(self, request_id: str) -> dict | None:
        t0 = time.perf_counter()
        raw = tbase.fetch_kv_manifest_bytes(self.transport, request_id)
        if raw is None:
            obs.count("serve.kv_manifest_misses")
            return None
        man = parse_kv_manifest(raw)
        if man is None:
            obs.count("serve.kv_manifest_rejects")
            return None
        out_pages = []
        for digest, nbytes in man["pages"]:
            hit = self.store.lookup(digest)
            if hit is not None:
                obs.count("serve.kv_pages_deduped")
                out_pages.append(hit)
                continue
            data = tbase.fetch_kv_page(self.transport, digest)
            # a torn publication, an eviction or a hostile store: each
            # degrades the same way, to no transfer
            pair = None
            if data is not None and len(data) == nbytes and \
                    ser.shard_digest(data) == digest:
                pair = unpack_kv_page(data)
            if pair is None:
                obs.count("serve.kv_page_rejects")
                return None
            self.bytes_fetched += len(data)
            obs.count("serve.kv_fetch_bytes", len(data))
            self.store.put(digest, *pair)
            out_pages.append(pair)
        self.adoptions += 1
        obs.observe("serve.kv_fetch_ms", (time.perf_counter() - t0) * 1e3)
        return {**man, "pages": out_pages}
