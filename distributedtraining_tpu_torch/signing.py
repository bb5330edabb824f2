"""Ed25519 artifact envelopes — the port of the JAX package's
``signing.py``, byte for byte: the same magic, header, contexts and
rules, so an artifact either package signed verifies in the other.

Wire format (fixed-size header after a 1-byte context length)::

    MAGIC(6) || ctx_len(1) || context || pubkey(32) || signature(64) || payload

The signature covers ``context || payload``, where context is a short
domain-separation string (``delta:<hotkey>`` / ``base:<hotkey>[:seq]``):
a miner's signed delta can never be replayed as a base, or under another
hotkey once the verifier knows the expected signer. Unsigned payloads (no
MAGIC prefix) pass through untouched; whether they are *accepted* is the
policy of ``transport/signed.py``. ``strip_envelope`` drops an envelope
without verifying it: plain transports call it, so a node that does not
sign still reads a signed fleet's artifacts.

The signer hashes the context and the payload as two chunks
(``utils/identity.py``); nothing here concatenates them before hashing.
"""

from __future__ import annotations

from .serialization import PayloadError

MAGIC = b"DTSG2\x00"
_PUB_LEN = 32
_SIG_LEN = 64
_MAX_CTX = 255


def delta_context(hotkey: str) -> bytes:
    return b"delta:" + hotkey.encode()


def base_context(hotkey: str) -> bytes:
    return b"base:" + hotkey.encode()


def is_enveloped(data) -> bool:
    return bytes(data[:len(MAGIC)]) == MAGIC


def _parse(data) -> tuple[bytes, bytes, bytes, memoryview]:
    """(context, pub, sig, payload view) of an enveloped blob;
    PayloadError on truncation."""
    if len(data) < len(MAGIC) + 1:
        raise PayloadError("truncated signature envelope")
    ctx_len = data[len(MAGIC)]
    hdr_len = len(MAGIC) + 1 + ctx_len + _PUB_LEN + _SIG_LEN
    if len(data) < hdr_len:
        raise PayloadError("truncated signature envelope")
    off = len(MAGIC) + 1
    ctx = bytes(data[off:off + ctx_len])
    off += ctx_len
    pub = bytes(data[off:off + _PUB_LEN])
    off += _PUB_LEN
    sig = bytes(data[off:off + _SIG_LEN])
    return ctx, pub, sig, memoryview(data)[off + _SIG_LEN:]


def strip_envelope(data: bytes) -> bytes:
    """Payload bytes WITHOUT signature verification (plain transports:
    the same trust as any unsigned artifact)."""
    if not is_enveloped(data):
        return data
    return bytes(_parse(data)[3])


def wrap(payload: bytes, identity, context: bytes) -> bytes:
    """Sign ``payload`` under ``context`` and prepend the envelope header."""
    if len(context) > _MAX_CTX:
        raise ValueError(f"context too long ({len(context)} > {_MAX_CTX})")
    sig = identity.sign((context, payload))
    assert len(identity.public_bytes) == _PUB_LEN and len(sig) == _SIG_LEN
    return b"".join((MAGIC, bytes([len(context)]), context,
                     identity.public_bytes, sig, payload))


def unwrap_with_context(data: bytes,
                        expected_context: bytes | None = None, *,
                        context_prefix: bytes | None = None,
                        kind: bytes | None = None,
                        expected_pub: bytes | None = None,
                        require: bool = False) -> tuple[bytes, bytes | None]:
    """Verify and strip the envelope -> (payload, context).

    - enveloped, valid, and matching ``expected_context`` /
      ``context_prefix`` / ``kind`` / ``expected_pub`` when given ->
      (payload, context);
    - enveloped but invalid or mismatched -> PayloadError (a forgery never
      degrades to "unsigned");
    - not enveloped -> (payload, None), or PayloadError with ``require``.

    ``kind`` checks only the context's domain prefix; ``context_prefix``
    matches exactly or with a ``:<suffix>`` (the anti-rollback sequence)."""
    from .utils.identity import Identity

    if not is_enveloped(data):
        if require:
            raise PayloadError("unsigned payload where a signature is required")
        return data, None
    ctx, pub, sig, payload = _parse(data)
    if expected_context is not None and ctx != expected_context:
        raise PayloadError(
            f"envelope context {ctx!r} does not match expected "
            f"{expected_context!r}")
    if context_prefix is not None and ctx != context_prefix \
            and not ctx.startswith(context_prefix + b":"):
        raise PayloadError(
            f"envelope context {ctx!r} does not match expected "
            f"{context_prefix!r}")
    if kind is not None and not ctx.startswith(kind + b":"):
        raise PayloadError(
            f"envelope context {ctx!r} is not a {kind.decode()!r} artifact")
    if expected_pub is not None and pub != expected_pub:
        raise PayloadError("envelope public key does not match the hotkey's "
                           "registered key")
    try:
        signer = Identity.public_only(pub)
    except Exception as e:
        raise PayloadError(f"bad envelope public key: {e}") from e
    if not signer.verify((ctx, payload), sig):
        raise PayloadError("invalid artifact signature")
    return bytes(payload), ctx


def unwrap(data: bytes, expected_context: bytes | None = None, *,
           kind: bytes | None = None,
           expected_pub: bytes | None = None,
           require: bool = False) -> bytes:
    """See unwrap_with_context; returns the payload alone."""
    return unwrap_with_context(data, expected_context, kind=kind,
                               expected_pub=expected_pub,
                               require=require)[0]


def context_seq(ctx: bytes | None, prefix: bytes) -> int:
    """The anti-rollback sequence a context carries after ``prefix + b':'``
    (0 when absent, unsigned or malformed)."""
    if ctx is None or not ctx.startswith(prefix + b":"):
        return 0
    try:
        return int(ctx[len(prefix) + 1:])
    except ValueError:
        return 0
