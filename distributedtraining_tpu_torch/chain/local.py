"""Local chain simulator: JSON-file metagraph + weights, no network — a
copy of the JAX package's ``chain/local.py`` over the port's own
``engine/scheduler.py``. The files are the same, so a JAX validator's
``set_weights`` in one directory is what the port averager's
``consensus_scores`` reads there.

Parity with the reference's simulator (LocalBittensorNetwork,
btt_connector.py:530-671; LocalAddressStore, chain_manager.py:124-168):

- 100 hotkeys; uids 0-90 have stake 10 (miners), uids 91-99 stake 10000
  (validators) — btt_connector.py:573-606
- weights persisted to <dir>/metagraph.json (btt_connector.py:608-628)
- address store persisted to <dir>/storage.json (chain_manager.py:133-150)
- block = seconds since epoch start / 12 (substrate block time); weight-set
  gating every ``epoch_length`` blocks (should_set_weights,
  btt_connector.py:382-385, base_subnet_config.py:72-77)
- EMA score smoothing + rate limiting + MAD anomaly screening shared with the
  real impl via chain/base.py

Safe for multi-process use on one box: file writes are atomic-rename.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Optional

from ..engine.scheduler import Clock, RealClock
from .base import (
    EMA_ALPHA,
    Metagraph,
    RateLimiter,
    ema_update,
    mad_anomaly_mask,
    normalize_scores,
    quantize_u16,
)

N_HOTKEYS = 100
VALIDATOR_UIDS = range(91, 100)  # btt_connector.py:603-606
MINER_STAKE = 10.0
VALIDATOR_STAKE = 10000.0
BLOCK_SECONDS = 12.0


def _atomic_write_json(path: str, obj) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _read_json(path: str, default):
    if not os.path.exists(path):
        return default
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return default


class LocalAddressStore:
    """hotkey -> repo id in storage.json; hotkey -> pubkey in pubkeys.json
    (the artifact-authenticity anchor for SignedTransport — on bittensor the
    hotkey IS the public key, here it must be registered once).

    Read-modify-write cycles hold an fcntl lock on a sidecar lockfile: the
    store is shared by SEPARATE role processes on one box (SURVEY §4.1
    multi-process rounds), and a thread lock alone would let two booting
    roles lose each other's registrations — for pubkeys that silently
    voids the trust-on-first-use guarantee."""

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(directory, "storage.json")
        self.pubkey_path = os.path.join(directory, "pubkeys.json")
        self._lock = threading.Lock()

    def _file_lock(self):
        import contextlib
        import fcntl

        @contextlib.contextmanager
        def held():
            os.makedirs(self.directory, exist_ok=True)
            with self._lock, open(os.path.join(self.directory,
                                               ".store.lock"), "w") as f:
                fcntl.flock(f, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(f, fcntl.LOCK_UN)
        return held()

    def store_repo(self, hotkey: str, repo_id: str) -> None:
        with self._file_lock():
            data = _read_json(self.path, {})
            data[hotkey] = repo_id
            _atomic_write_json(self.path, data)

    def retrieve_repo(self, hotkey: str) -> Optional[str]:
        return _read_json(self.path, {}).get(hotkey)

    def store_pubkey(self, hotkey: str, pubkey: bytes) -> None:
        """First write wins: an attacker must not be able to rotate a
        registered key out from under a hotkey (trust-on-first-use)."""
        with self._file_lock():
            data = _read_json(self.pubkey_path, {})
            if hotkey in data and data[hotkey] != pubkey.hex():
                raise ValueError(
                    f"pubkey for {hotkey} already registered; refusing to "
                    "overwrite")
            data[hotkey] = pubkey.hex()
            _atomic_write_json(self.pubkey_path, data)

    def retrieve_pubkey(self, hotkey: str) -> Optional[bytes]:
        hexkey = _read_json(self.pubkey_path, {}).get(hotkey)
        return bytes.fromhex(hexkey) if hexkey else None


class LocalChain:
    """Network impl backed by metagraph.json."""

    def __init__(self, directory: str, *, my_hotkey: str = "hotkey_0",
                 epoch_length: int = 100, clock: Clock | None = None,
                 rate_limit_seconds: float = 0.0,
                 vpermit_stake_limit: float = 1000.0):
        self.directory = directory
        self.path = os.path.join(directory, "metagraph.json")
        self._my_hotkey = my_hotkey
        self.epoch_length = epoch_length
        self.clock = clock or RealClock()
        self._epoch_start = self.clock.now()
        self.rate_limit_seconds = rate_limit_seconds
        self.vpermit_stake_limit = vpermit_stake_limit
        self._limiter = RateLimiter(rate_limit_seconds,
                                    now_fn=self.clock.now)
        self._lock = threading.Lock()
        self._last_weight_block = -(10**9)
        if not os.path.exists(self.path):
            self._init_metagraph()

    # -- genesis ------------------------------------------------------------
    def _init_metagraph(self) -> None:
        hotkeys = [f"hotkey_{i}" for i in range(N_HOTKEYS)]
        stakes = [VALIDATOR_STAKE if i in VALIDATOR_UIDS else MINER_STAKE
                  for i in range(N_HOTKEYS)]
        _atomic_write_json(self.path, {
            "hotkeys": hotkeys,
            "uids": list(range(N_HOTKEYS)),
            "stakes": stakes,
            "weights": {},       # validator_hotkey -> {miner_hotkey: weight}
            "ema_scores": {},    # validator_hotkey -> {miner_hotkey: score}
        })

    def _state(self) -> dict:
        return _read_json(self.path, {})

    # -- Network API --------------------------------------------------------
    @property
    def my_hotkey(self) -> str:
        return self._my_hotkey

    def sync(self) -> Metagraph:
        s = self._state()
        return Metagraph(hotkeys=s["hotkeys"], uids=s["uids"],
                         stakes=s["stakes"], block=self.current_block())

    def current_block(self) -> int:
        return int((self.clock.now() - self._epoch_start) / BLOCK_SECONDS)

    def get_validator_uids(self, stake_limit: float | None = None) -> list[int]:
        """UIDs with stake >= the vpermit limit (btt_connector.py:358-380;
        --neuron.vpermit_tao_limit, base_subnet_config.py:178-183)."""
        limit = self.vpermit_stake_limit if stake_limit is None else stake_limit
        s = self._state()
        return [u for u, st in zip(s["uids"], s["stakes"]) if st >= limit]

    def should_set_weights(self) -> bool:
        """Block-epoch gate (btt_connector.py:382-385)."""
        return (self.current_block() - self._last_weight_block) >= self.epoch_length

    def set_weights(self, scores: dict[str, float]) -> bool:
        """EMA -> anomaly screen -> normalize -> quantize -> persist."""
        with self._lock:
            s = self._state()
            prev = s.get("ema_scores", {}).get(self._my_hotkey, {})
            ema = ema_update(prev, scores, EMA_ALPHA)
            # MAD screen: anomalously high scores are zeroed (cheater guard,
            # btt_connector.py:388-426). Screen only among positive scorers —
            # most hotkeys legitimately score 0, and a zero-median MAD would
            # otherwise flag every real score as an outlier.
            keys = list(ema)
            pos = [k for k in keys if ema[k] > 0]
            flags = dict(zip(pos, mad_anomaly_mask([ema[k] for k in pos])))
            screened = {k: (0.0 if flags.get(k, False) else ema[k])
                        for k in keys}
            norm = normalize_scores(screened)
            q = quantize_u16([norm[k] for k in keys])
            s.setdefault("ema_scores", {})[self._my_hotkey] = ema
            s.setdefault("weights", {})[self._my_hotkey] = {
                k: int(v) for k, v in zip(keys, q)}
            _atomic_write_json(self.path, s)
            self._last_weight_block = self.current_block()
            return True

    def get_weights(self, validator_hotkey: str | None = None) -> dict[str, int]:
        s = self._state()
        return s.get("weights", {}).get(validator_hotkey or self._my_hotkey, {})

    def consensus_scores(self) -> dict[str, float]:
        """Stake-weighted mean of all validators' normalized weights — what the
        averager uses as miner trust priors (averaging_logic.py:129-147)."""
        s = self._state()
        stake = dict(zip(s["hotkeys"], s["stakes"]))
        acc: dict[str, float] = {}
        total_stake = 0.0
        for vk, w in s.get("weights", {}).items():
            vs = stake.get(vk, 0.0)
            if vs <= 0 or not w:
                continue
            total_stake += vs
            wsum = sum(w.values()) or 1
            for mk, wv in w.items():
                acc[mk] = acc.get(mk, 0.0) + vs * (wv / wsum)
        if total_stake > 0:
            acc = {k: v / total_stake for k, v in acc.items()}
        return acc

    # -- abuse guards (rate limiter + blacklist, btt_connector.py:454-480) --
    BLACKLIST_AFTER = RateLimiter.BLACKLIST_AFTER

    def rate_limit(self, caller: str) -> bool:
        """True = allowed — delegates to the shared RateLimiter policy."""
        return self._limiter.allow(caller)
