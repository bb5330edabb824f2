"""Participant identities — the port of the JAX package's
``utils/identity.py``: Ed25519 keypairs, a hotkey string derived from
the public key, JSON-file wallets and detached sign/verify over payload
bytes. The wallet file is the JAX package's, so a wallet either package
wrote loads in the other.

Ed25519 is the port's own (``utils/ed25519.py``, RFC 8032 on
``hashlib``): the port depends on no crypto package. For the same
private seed, keys and signatures equal ``cryptography``'s.
``sign``/``verify`` take bytes or a sequence of byte chunks (hashed in
order), so a signer never concatenates a context with a large payload.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import secrets
from typing import Optional

from . import ed25519


def _hotkey_from_public(pub_bytes: bytes) -> str:
    """Short, stable, human-greppable id: 'hk' + 20 hex chars of SHA-256."""
    return "hk" + hashlib.sha256(pub_bytes).hexdigest()[:20]


@dataclasses.dataclass
class Identity:
    hotkey: str
    public_bytes: bytes
    _private: Optional[bytes] = None     # the 32-byte private seed

    # -- creation -----------------------------------------------------------
    @classmethod
    def generate(cls) -> "Identity":
        return cls.from_private_bytes(secrets.token_bytes(32))

    @classmethod
    def from_private_bytes(cls, data: bytes) -> "Identity":
        seed = bytes(data)
        pub = ed25519.public_key(seed)
        return cls(hotkey=_hotkey_from_public(pub), public_bytes=pub,
                   _private=seed)

    @classmethod
    def public_only(cls, pub_bytes: bytes) -> "Identity":
        pub = bytes(pub_bytes)
        return cls(hotkey=_hotkey_from_public(pub), public_bytes=pub)

    # -- signing ------------------------------------------------------------
    def sign(self, message) -> bytes:
        if self._private is None:
            raise ValueError("public-only identity cannot sign")
        return ed25519.sign(self._private, message, public=self.public_bytes)

    def verify(self, message, signature: bytes) -> bool:
        return ed25519.verify(self.public_bytes, message, signature)

    # -- storage ------------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        payload = {
            "hotkey": self.hotkey,
            "public": self.public_bytes.hex(),
            "private": self._private.hex() if self._private else None,
        }
        tmp = path + ".tmp"
        # owner-only from birth (the payload holds the private key): a
        # stale tmp from a crash keeps its old mode, so unlink it and
        # create exclusively
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=2)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "Identity":
        with open(path) as f:
            payload = json.load(f)
        if payload.get("private"):
            ident = cls.from_private_bytes(bytes.fromhex(payload["private"]))
        else:
            ident = cls.public_only(bytes.fromhex(payload["public"]))
        if ident.hotkey != payload["hotkey"]:
            raise ValueError(f"wallet {path}: hotkey does not match key")
        return ident


def generate_wallets(directory: str, n: int) -> list[Identity]:
    """Generate ``n`` wallets under ``directory`` as ``wallet_<i>.json``."""
    idents = []
    for i in range(n):
        ident = Identity.generate()
        ident.save(os.path.join(directory, f"wallet_{i}.json"))
        idents.append(ident)
    return idents


def load_wallets(directory: str) -> list[Identity]:
    names = sorted(f for f in os.listdir(directory) if f.endswith(".json"))
    return [Identity.load(os.path.join(directory, f)) for f in names]
