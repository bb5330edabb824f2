"""Msgpack serialization of parameter trees — the port of the msgpack half
of the JAX package's ``serialization.py`` (``to_msgpack``,
``from_msgpack``, ``PayloadError``, ``save_file``, ``load_file``).

The JAX package encodes trees with ``flax.serialization``; the card
machine has neither ``flax``, ``msgpack`` nor ``ml_dtypes``, so this
module carries its own encoder and decoder for the subset flax emits, and
produces THE SAME BYTES for the same tree:

- maps with str keys, in the order of ``jax.tree_util`` (sorted);
- every leaf as msgpack ext type 1: ``packb((shape, dtype_name, raw
  C-order bytes))`` (the JAX package turns every leaf into an ndarray
  first, scalars included, so ext type 3, an np scalar, is only ever
  decoded);
- a leaf above ``MAX_CHUNK_SIZE`` bytes as flax's ``_chunk`` map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
  "chunks": {"0": ..., ...}}``;
- ints, floats, bools, None, str, bin and arrays as msgpack-python packs
  them.

bf16 leaves travel as dtype name ``"bfloat16"`` with raw 2-byte payloads.
numpy has no bf16 on the card machine, so they are written from and read
into ``torch.bfloat16`` tensors; every other dtype reads as a numpy array.

Trees are nested dicts in the JAX layout (``h_0/attn/c_attn/kernel``);
leaves are numpy arrays, numpy scalars or CPU tensors. Loads restore BY
EXAMPLE: with a template, the payload must carry every template key and
each leaf's shape, or :class:`PayloadError` is raised. The wire-v2 shard
container and manifest (``pack_shard``, ``build_wire_manifest``, ...) are
here too; safetensors and the base manifest come with a later slice.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Mapping

import numpy as np
import torch

Params = Any

# Hard cap on accepted payloads (bytes): an untrusted peer must not be able
# to OOM a reader with one submission. 8 GiB covers an 8B-param bf16 delta.
DEFAULT_MAX_BYTES = 8 * 1024**3

# flax's leaf-size limit for one msgpack object (it reads the module global
# at call time, and so does this module)
MAX_CHUNK_SIZE = 2**30

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class PayloadError(ValueError):
    """Raised when an untrusted payload fails validation."""


# ---------------------------------------------------------------------------
# msgpack encoding (the msgpack-python packer's choices, byte for byte)
# ---------------------------------------------------------------------------

def _int(v: int) -> bytes:
    if v >= 0:
        if v < 0x80:
            return bytes((v,))
        if v <= 0xFF:
            return b"\xcc" + struct.pack(">B", v)
        if v <= 0xFFFF:
            return b"\xcd" + struct.pack(">H", v)
        if v <= 0xFFFFFFFF:
            return b"\xce" + struct.pack(">I", v)
        return b"\xcf" + struct.pack(">Q", v)
    if v >= -32:
        return struct.pack(">b", v)
    if v >= -0x80:
        return b"\xd0" + struct.pack(">b", v)
    if v >= -0x8000:
        return b"\xd1" + struct.pack(">h", v)
    if v >= -0x80000000:
        return b"\xd2" + struct.pack(">i", v)
    return b"\xd3" + struct.pack(">q", v)


def _header(n: int, fix: int, fix_max: int, codes: tuple) -> bytes:
    """Length header: a fix form below ``fix_max``, else the 8/16/32-bit
    forms in ``codes`` (None where msgpack has no such form)."""
    if n < fix_max:
        return bytes((fix | n,))
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too large")


def _str(v: str) -> bytes:
    raw = v.encode("utf-8")
    return _header(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + raw


def _bin(v: bytes) -> bytes:
    n = len(v)
    if n <= 0xFF:
        return b"\xc4" + struct.pack(">B", n) + v
    if n <= 0xFFFF:
        return b"\xc5" + struct.pack(">H", n) + v
    return b"\xc6" + struct.pack(">I", n) + v


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes((fixed[n],))
    elif n <= 0xFF:
        head = b"\xc7" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        head = b"\xc8" + struct.pack(">H", n)
    else:
        head = b"\xc9" + struct.pack(">I", n)
    return head + struct.pack(">b", code) + data


def _leaf_parts(x) -> tuple[tuple, str, bytes]:
    """``(shape, dtype name, raw C-order bytes)`` of a host leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (tuple(t.shape), "bfloat16",
                    t.view(torch.int16).numpy().tobytes())
        x = t.numpy()
    arr = np.asarray(x)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be "
                         "serialized")
    return arr.shape, arr.dtype.name, arr.tobytes("C")


def _ndarray_ext(x) -> bytes:
    shape, name, raw = _leaf_parts(x)
    body = (_header(len(shape), 0x90, 16, (None, 0xDC, 0xDD))
            + b"".join(_int(int(d)) for d in shape) + _str(name) + _bin(raw))
    return _ext(_EXT_NDARRAY, b"\x93" + body)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def _chunk(x) -> dict:
    """flax's ``_chunk``: the flattened leaf cut into pieces of at most
    ``MAX_CHUNK_SIZE`` bytes, with its shape, as a map."""
    if isinstance(x, torch.Tensor):
        flat, itemsize = x.detach().cpu().reshape(-1), x.element_size()
        size = flat.numel()
    else:
        flat = np.asarray(x).reshape(-1)
        itemsize, size = flat.dtype.itemsize, flat.size
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    shape = tuple(x.shape)
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(shape)},
            "chunks": {str(i): flat[j: j + step]
                       for i, j in enumerate(range(0, size, step))}}


def _is_leaf(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, torch.Tensor))


def _encode(obj, out: list, *, top: bool) -> None:
    """Append the encoding of ``obj`` to ``out``. ``top`` marks the tree
    as the JAX package sees it (sorted keys, leaves as ndarrays); below a
    chunk map the values pack as they are (insertion order, Python
    ints)."""
    if isinstance(obj, Mapping):
        out.append(_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF)))
        keys = sorted(obj) if top else list(obj)
        for k in keys:
            out.append(_str(str(k)))
            _encode(obj[k], out, top=top)
        return
    if top:
        if not _is_leaf(obj):
            obj = np.asarray(obj)
        if _nbytes(obj) > MAX_CHUNK_SIZE:
            _encode(_chunk(obj), out, top=False)
        else:
            out.append(_ndarray_ext(obj))
        return
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        out.append(_str(obj))
    elif type(obj) is bytes:
        out.append(_bin(obj))
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        out.append(_ndarray_ext(obj))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _pieces(tree: Params) -> list:
    out: list = []
    _encode(tree, out, top=True)
    return out


def to_msgpack(tree: Params) -> bytes:
    """Serialize a tree of host arrays (nested str-keyed dicts) to msgpack
    bytes, byte-identical to the JAX package's ``to_msgpack`` of the same
    tree."""
    return b"".join(_pieces(tree))


# ---------------------------------------------------------------------------
# msgpack decoding
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if n < 0 or end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED_EXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _decode(r: _Reader, raw: bool):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_decode(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _text(r.take(b & 0x1F), raw)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in (0xC4, 0xC5, 0xC6):
        n = r.unpack((">B", ">H", ">I")[b - 0xC4])
        return bytes(r.take(n))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack((">B", ">H", ">I")[b - 0xC7])
        code = r.unpack(">b")
        return _ext_value(code, r.take(n))
    if b in _FIXED_EXT:
        code = r.unpack(">b")
        return _ext_value(code, r.take(_FIXED_EXT[b]))
    if b in _SCALARS:
        return r.unpack(_SCALARS[b])
    if b in (0xD9, 0xDA, 0xDB):
        n = r.unpack((">B", ">H", ">I")[b - 0xD9])
        return _text(r.take(n), raw)
    if b in (0xDC, 0xDD):
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_decode(r, raw) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _map(r, r.unpack(">H" if b == 0xDE else ">I"), raw)
    raise ValueError(f"invalid msgpack type byte 0x{b:02x}")


def _text(data: memoryview, raw: bool):
    return bytes(data) if raw else str(data, "utf-8")


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r, raw)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"map key of type {type(k).__name__}")
        out[k] = _decode(r, raw)
    return out


def _unpackb(data, raw: bool = False):
    r = _Reader(data)
    out = _decode(r, raw)
    if r.pos != len(r.buf):
        raise ValueError("extra data after the msgpack object")
    return out


def _array_from(data: memoryview):
    """flax's ``_ndarray_from_bytes``: bf16 as a torch tensor, every other
    dtype as a numpy array over the payload's bytes."""
    shape, name, buf = _unpackb(data, raw=True)
    shape = tuple(int(d) for d in shape)
    if name == b"bfloat16":
        flat = np.frombuffer(buf, dtype=np.int16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape)


def _ext_value(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _array_from(data)
    if code == _EXT_NPSCALAR:
        return _array_from(data)[()]
    if code == _EXT_COMPLEX:
        re_, im = _unpackb(data)
        return complex(re_, im)
    raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk(node):
    if isinstance(node, dict):
        if _CHUNKED in node:
            shape = tuple(node["shape"][str(i)]
                          for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)]
                      for i in range(len(node["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))


def _restore(template, raw, path: str):
    """``flax.serialization.from_state_dict`` for nested dicts, plus the
    JAX package's per-leaf shape check."""
    if isinstance(template, Mapping):
        if not isinstance(raw, dict):
            raise PayloadError(f"structure mismatch at {path or '/'!r}: "
                               f"expected a map")
        missing = {str(k) for k in template} - set(raw)
        if missing:
            raise PayloadError(f"structure mismatch: keys {sorted(missing)} "
                               f"missing at {path or '/'!r}")
        return {k: _restore(v, raw[str(k)], f"{path}/{k}" if path else str(k))
                for k, v in template.items()}
    if not _is_leaf(raw):
        raise PayloadError(f"structure mismatch at {path!r}: expected an "
                           f"array, got {type(raw).__name__}")
    if _shape(raw) != _shape(template):
        raise PayloadError(f"shape mismatch at {path!r}: {_shape(raw)} vs "
                           f"{_shape(template)}")
    return raw


def from_msgpack(data: bytes, template: Params | None = None,
                 *, max_bytes: int = DEFAULT_MAX_BYTES) -> Params:
    """Deserialize msgpack bytes. With a ``template`` (a nested dict whose
    leaves have shapes), the result is restored into the template's
    structure and every mismatch raises :class:`PayloadError`: the only
    loader for peer payloads."""
    if len(data) > max_bytes:
        raise PayloadError(f"payload {len(data)} bytes exceeds cap "
                           f"{max_bytes}")
    try:
        raw = _unchunk(_unpackb(data))
    except (ValueError, TypeError, KeyError, IndexError, struct.error,
            RecursionError, UnicodeDecodeError) as e:
        raise PayloadError(f"malformed msgpack: {e}") from e
    if template is None:
        return raw
    return _restore(template, raw, "")


# ---------------------------------------------------------------------------
# Validated file IO (the transports call these)
# ---------------------------------------------------------------------------

def save_file(tree: Params, path: str) -> None:
    """Write a tree to ``path`` as msgpack, atomically: a temporary file,
    fsync, then rename, so a reader never sees a torn artifact, even
    after a crash."""
    if not path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: only .msgpack is ported; safetensors comes with the "
            f"checkpoint slice, ROADMAP 'Slices of the port', slice 5")
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        for piece in _pieces(tree):
            f.write(piece)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_file(path: str, template: Params | None = None,
              *, max_bytes: int = DEFAULT_MAX_BYTES) -> Params:
    size = os.path.getsize(path)
    if size > max_bytes:
        raise PayloadError(f"file {path} is {size} bytes, exceeds cap "
                           f"{max_bytes}")
    with open(path, "rb") as f:
        return from_msgpack(f.read(), template, max_bytes=max_bytes)


def validated_load(data: bytes, template: Params, *,
                   max_bytes: int = DEFAULT_MAX_BYTES,
                   check_dtypes: bool = False) -> Params:
    """Untrusted msgpack bytes restored into ``template``'s structure with
    per-leaf shapes checked; ``check_dtypes=True`` also pins every leaf to
    the template's dtype (the int8 wire: a hostile f64 ``q`` tree would
    otherwise parse at 8x the advertised bytes)."""
    from . import delta as _delta

    tree = from_msgpack(data, template, max_bytes=max_bytes)
    if not _delta.shapes_match(tree, template, check_dtype=check_dtypes):
        raise PayloadError("leaf shape/dtype mismatch against template")
    return tree


# ---------------------------------------------------------------------------
# Wire v2 shard container: per-layer shards addressed by a manifest
#
# A v2 publish is N per-layer shards (one packed {"idx", "q", "scale"}
# entry each, msgpack) plus one small manifest that names each shard's
# sha256. The manifest travels as the miner's delta artifact; shards travel
# under reserved ids (transport/base.py). Ingest verifies every fetched
# shard against the manifest's hash: the dedupe key and the torn-publish
# guard at once. Shard and manifest bytes equal the JAX package's for the
# same packed tree.
# ---------------------------------------------------------------------------

# manifest prefix: deliberately not msgpack, so no v1 decode half-accepts it
WIRE_V2_MAGIC = b"DTWIRE2\n"
# a manifest names one ~100-byte entry per wire tensor; 1 MiB is hostile
WIRE_MANIFEST_MAX_BYTES = 1 << 20
_WIRE_MAX_LAYERS = 16384
_WIRE_KEY_MAX = 512


def shard_digest(data: bytes) -> str:
    """Content address of one shard's bytes (sha256 hex)."""
    import hashlib
    return hashlib.sha256(data).hexdigest()


def pack_shard(entry: Mapping) -> bytes:
    """One packed per-layer entry ``{"idx", "q", "scale"}`` -> shard bytes
    (msgpack). The publisher's own data: malformed input raises."""
    if not isinstance(entry, Mapping) or set(entry) != {"idx", "q", "scale"}:
        raise ValueError("pack_shard: expected a {'idx','q','scale'} entry")
    return to_msgpack({k: (v.detach().cpu().numpy()
                           if isinstance(v, torch.Tensor) else np.asarray(v))
                       for k, v in entry.items()})


def unpack_shard(data: bytes, *, max_bytes: int = DEFAULT_MAX_BYTES
                 ) -> dict | None:
    """Shard bytes -> packed entry, or None. Structural validation only
    (key set, array fields); the fields are validated against the base
    template at assembly (``delta._packed_tree_fields``)."""
    if len(data) > max_bytes:
        return None
    try:
        raw = from_msgpack(bytes(data), None, max_bytes=max_bytes)
    except PayloadError:
        return None
    if not isinstance(raw, dict) or set(raw) != {"idx", "q", "scale"}:
        return None
    if not all(isinstance(v, np.ndarray) for v in raw.values()):
        return None
    return raw


def build_wire_manifest(layers: Mapping[str, tuple[str, int]], *,
                        density: float, quant: str) -> bytes:
    """``{layer_key: (shard sha256, shard nbytes)}`` -> manifest bytes
    (magic + canonical JSON)."""
    import json
    body = {"format": 2, "quant": quant, "density": density,
            "layers": {str(k): {"h": h, "n": int(n)}
                       for k, (h, n) in sorted(layers.items())}}
    data = WIRE_V2_MAGIC + json.dumps(
        body, sort_keys=True, separators=(",", ":")).encode()
    if len(data) > WIRE_MANIFEST_MAX_BYTES:
        raise PayloadError(f"wire manifest {len(data)} bytes exceeds cap "
                           f"{WIRE_MANIFEST_MAX_BYTES}")
    return data


def is_wire_v2_manifest(data) -> bool:
    return (isinstance(data, (bytes, bytearray, memoryview))
            and bytes(data[:len(WIRE_V2_MAGIC)]) == WIRE_V2_MAGIC)


def _validated_manifest_layers(layers) -> dict | None:
    """The layer table ``{key: {"h": sha256-hex, "n": int}}``, or None."""
    if not isinstance(layers, dict) or len(layers) > _WIRE_MAX_LAYERS:
        return None
    out_layers = {}
    for key, info in layers.items():
        if not isinstance(key, str) or not 0 < len(key) <= _WIRE_KEY_MAX:
            return None
        if not isinstance(info, dict):
            return None
        h, n = info.get("h"), info.get("n")
        if not (isinstance(h, str) and len(h) == 64
                and all(c in "0123456789abcdef" for c in h)):
            return None
        if not (isinstance(n, int) and 0 <= n <= DEFAULT_MAX_BYTES):
            return None
        out_layers[key] = {"h": h, "n": n}
    return out_layers


def parse_wire_manifest(data: bytes) -> dict | None:
    """PEER-CONTROLLED manifest bytes -> ``{"quant", "density", "layers":
    {key: {"h", "n"}}}`` or None. Magic, size cap, JSON shape, format
    number and the layer table's bounds are all validated: a manifest that
    parses can at worst make ingest fetch bounded bytes that then fail
    their hash check."""
    import json
    if not is_wire_v2_manifest(data) or len(data) > WIRE_MANIFEST_MAX_BYTES:
        return None
    try:
        body = json.loads(bytes(data[len(WIRE_V2_MAGIC):]).decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(body, dict) or body.get("format") != 2:
        return None
    out_layers = _validated_manifest_layers(body.get("layers"))
    if out_layers is None:
        return None
    quant = body.get("quant")
    density = body.get("density")
    return {"quant": quant if isinstance(quant, str) else "int8",
            "density": float(density)
            if isinstance(density, (int, float)) else None,
            "layers": out_layers}
