"""Ed25519 (RFC 8032, pure): key derivation, signing and verification on
``hashlib.sha512`` and Python integers.

The port carries its own Ed25519 so that it depends on no crypto
package (``cryptography`` is not among its dependencies). Signatures are deterministic, so for the same
32-byte private seed the public key and signature bytes equal any other
conforming implementation's (``cryptography``'s among them; pinned in
tests/test_torch_signing.py). Verification is the cofactorless check
OpenSSL performs: ``S < L``, ``A`` decodes to a curve point, and the
encoding of ``[S]B - [k]A`` equals ``R``.

Messages are passed as a sequence of byte chunks (bytes, bytearray or
memoryview) and hashed with incremental ``update`` calls, so signing a
context and a 498 MB payload never concatenates them. Signing hashes the
message twice (the nonce, then the challenge); verifying hashes it once.
Not constant-time: the keys here authenticate artifacts on a shared
store, they do not guard a secret against a co-resident attacker.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Union

Chunk = Union[bytes, bytearray, memoryview]

_P = 2 ** 255 - 19
_L = 2 ** 252 + 27742317777372353535851937790883648493
_D = (-121665 * pow(121666, _P - 2, _P)) % _P
_SQRT_M1 = pow(2, (_P - 1) // 4, _P)

_BY = (4 * pow(5, _P - 2, _P)) % _P


def _recover_x(y: int, sign: int) -> int | None:
    if y >= _P:
        return None
    x2 = (y * y - 1) * pow(_D * y * y + 1, _P - 2, _P) % _P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (_P + 3) // 8, _P)
    if (x * x - x2) % _P != 0:
        x = x * _SQRT_M1 % _P
    if (x * x - x2) % _P != 0:
        return None
    if (x & 1) != sign:
        x = _P - x
    return x


_BX = _recover_x(_BY, 0)
# extended homogeneous coordinates (X, Y, Z, T), x = X/Z, y = Y/Z, xy = T/Z
_B = (_BX, _BY, 1, _BX * _BY % _P)
_ZERO = (0, 1, 1, 0)


def _add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % _P
    b = (y1 + x1) * (y2 + x2) % _P
    c = 2 * t1 * t2 * _D % _P
    d = 2 * z1 * z2 % _P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % _P, g * h % _P, f * g % _P, e * h % _P)


def _double(p):
    x1, y1, z1, _ = p
    a = x1 * x1 % _P
    b = y1 * y1 % _P
    c = 2 * z1 * z1 % _P
    h = a + b
    e = h - (x1 + y1) * (x1 + y1)
    g = a - b
    f = c + g
    return (e * f % _P, g * h % _P, f * g % _P, e * h % _P)


def _mul(s: int, p):
    q = _ZERO
    while s > 0:
        if s & 1:
            q = _add(q, p)
        p = _double(p)
        s >>= 1
    return q


def _encode_point(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, _P - 2, _P)
    x, y = x * zi % _P, y * zi % _P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def _decode_point(data: bytes):
    if len(data) != 32:
        return None
    y = int.from_bytes(data, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % _P)


def _sha512_int(parts: Iterable[Chunk]) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little")


def _expand(seed: bytes) -> tuple[int, bytes]:
    if len(seed) != 32:
        raise ValueError(f"Ed25519 private key must be 32 bytes, got "
                         f"{len(seed)}")
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key(seed: bytes) -> bytes:
    """The 32-byte public key of a 32-byte private seed."""
    a, _ = _expand(seed)
    return _encode_point(_mul(a, _B))


def _chunks(message) -> list:
    if isinstance(message, (bytes, bytearray, memoryview)):
        return [message]
    return list(message)


def sign(seed: bytes, message, *, public: bytes | None = None) -> bytes:
    """The 64-byte signature of ``message`` (bytes, or a sequence of byte
    chunks hashed in order) under the private ``seed``."""
    a, prefix = _expand(seed)
    pub = public if public is not None else _encode_point(_mul(a, _B))
    parts = _chunks(message)
    r = _sha512_int([prefix, *parts]) % _L
    rs = _encode_point(_mul(r, _B))
    k = _sha512_int([rs, pub, *parts]) % _L
    s = (r + k * a) % _L
    return rs + int.to_bytes(s, 32, "little")


def verify(public: bytes, message, signature: bytes) -> bool:
    """True when ``signature`` is a valid signature of ``message`` (bytes,
    or a sequence of byte chunks) under ``public``."""
    if len(public) != 32 or len(signature) != 64:
        return False
    a_point = _decode_point(bytes(public))
    if a_point is None:
        return False
    rs = bytes(signature[:32])
    s = int.from_bytes(signature[32:], "little")
    if s >= _L:
        return False
    k = _sha512_int([rs, bytes(public), *_chunks(message)]) % _L
    x, y, z, t = _mul(k, a_point)
    neg_ka = ((_P - x) % _P, y, z, (_P - t) % _P)
    return _encode_point(_add(_mul(s, _B), neg_ka)) == rs
