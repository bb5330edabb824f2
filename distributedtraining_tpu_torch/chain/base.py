"""Chain protocols + shared weight-processing math — a copy of the JAX
package's ``chain/base.py`` (the port imports nothing of that package).

The score path reproduces BittensorNetwork.set_weights
(btt_connector.py:310-356): EMA smoothing (alpha=1/3), normalization, uint16
quantization for emission. The math lives here as pure functions so both the
local simulator and the real chain share one implementation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Sequence

import numpy as np

EMA_ALPHA = 1.0 / 3.0  # btt_connector.py:317-318
U16_MAX = 65535


@dataclasses.dataclass
class Metagraph:
    """Snapshot of subnet membership."""
    hotkeys: list[str]
    uids: list[int]
    stakes: list[float]
    block: int

    def uid_of(self, hotkey: str) -> int | None:
        try:
            return self.uids[self.hotkeys.index(hotkey)]
        except ValueError:
            return None


class AddressStore(Protocol):
    """hotkey -> artifact repo id (chain commitments, chain_manager.py:57-115)
    and hotkey -> signing pubkey (artifact authenticity, transport/signed.py)."""

    def store_repo(self, hotkey: str, repo_id: str) -> None: ...
    def retrieve_repo(self, hotkey: str) -> Optional[str]: ...
    def store_pubkey(self, hotkey: str, pubkey: bytes) -> None: ...
    def retrieve_pubkey(self, hotkey: str) -> Optional[bytes]: ...


class Network(Protocol):
    """Subnet membership + score emission (btt_connector.py:264-506)."""

    @property
    def my_hotkey(self) -> str: ...

    def sync(self) -> Metagraph: ...
    def current_block(self) -> int: ...
    def set_weights(self, scores: dict[str, float]) -> bool: ...
    def should_set_weights(self) -> bool: ...
    def get_validator_uids(self, stake_limit: float | None = None) -> list[int]: ...


class RateLimiter:
    """Too-fast callers are refused; repeat offenders get blacklisted
    (btt_connector.py:454-480). Shared by the chain simulator and the peer
    registry so every request-serving surface applies one policy. A single
    transient double-poll must not permanently ban a well-behaved hotkey."""

    BLACKLIST_AFTER = 3      # violations before a permanent ban
    MAX_TRACKED = 65536      # bound on per-caller bookkeeping entries

    def __init__(self, min_interval: float, *, now_fn=None,
                 max_tracked: int = MAX_TRACKED,
                 blacklist_after: int | None = BLACKLIST_AFTER):
        """``blacklist_after=None`` disables the permanent ban — REQUIRED on
        surfaces where the caller id is self-claimed (the peer registry's
        HTTP hotkeys): an attacker spoofing a victim's id must at worst
        rate-limit it, never lock it out forever."""
        import threading
        import time
        self.min_interval = min_interval
        self.max_tracked = max_tracked
        self.blacklist_after = blacklist_after
        self._now = now_fn or time.time
        self._last_request: dict[str, float] = {}
        self._violations: dict[str, int] = {}
        self._blacklist: set[str] = set()
        # callers include ThreadingHTTPServer handler threads (the peer
        # registry): the evict-while-iterating path must be serialized
        self._mutex = threading.Lock()

    def allow(self, caller: str) -> bool:
        if self.min_interval <= 0:
            # limiter disabled: keep NO per-caller state — an attacker
            # cycling distinct hotkeys must not grow server memory
            return True
        with self._mutex:
            return self._allow_locked(caller)

    def _allow_locked(self, caller: str) -> bool:
        if caller in self._blacklist:
            return False
        now = self._now()
        last = self._last_request.get(caller)
        if last is None and len(self._last_request) >= self.max_tracked:
            # evict the stalest half; distinct-hotkey floods stay bounded
            # (an evicted well-paced caller just gets one free pass)
            for k, _ in sorted(self._last_request.items(),
                               key=lambda kv: kv[1])[:self.max_tracked // 2]:
                del self._last_request[k]
                self._violations.pop(k, None)
        self._last_request[caller] = now
        if last is not None and now - last < self.min_interval:
            self._violations[caller] = self._violations.get(caller, 0) + 1
            if (self.blacklist_after is not None
                    and self._violations[caller] >= self.blacklist_after):
                if len(self._blacklist) >= self.max_tracked:
                    self._blacklist.pop()  # bounded, at the cost of un-banning
                self._blacklist.add(caller)
            return False
        return True


# ---------------------------------------------------------------------------
# Pure score-processing math (shared by all Network impls)
# ---------------------------------------------------------------------------

def ema_update(prev: dict[str, float], new: dict[str, float],
               alpha: float = EMA_ALPHA) -> dict[str, float]:
    """score <- alpha*new + (1-alpha)*prev per hotkey (btt_connector.py:315-321)."""
    out = dict(prev)
    for k, v in new.items():
        out[k] = alpha * v + (1 - alpha) * out.get(k, 0.0)
    return out


def normalize_scores(scores: dict[str, float]) -> dict[str, float]:
    total = sum(max(v, 0.0) for v in scores.values())
    if total <= 0:
        return {k: 0.0 for k in scores}
    return {k: max(v, 0.0) / total for k, v in scores.items()}


def quantize_u16(weights: Sequence[float]) -> list[int]:
    """Normalized float weights -> uint16 emission values
    (convert_weights_and_uids_for_emit, btt_connector.py:339-345)."""
    w = np.asarray(list(weights), dtype=np.float64)
    if w.size == 0 or w.max() <= 0:
        return [0] * w.size
    return [int(round(x)) for x in (w / w.max()) * U16_MAX]


def mad_anomaly_mask(values: Sequence[float], *, threshold: float = 3.5
                     ) -> list[bool]:
    """Median-absolute-deviation outlier flags (True = anomalous) —
    the reference's cheater detection (detect_metric_anomaly,
    btt_connector.py:388-426) using the modified z-score.

    ONE-SIDED by design: only anomalously HIGH scores are flagged (a
    gamed metric inflates; an honest-but-weaker miner deflates). The
    first two-sided spelling of this zeroed a legitimately positive
    miner whose score sat 4 MADs below a tight leader cluster — exactly
    the discrimination the validator exists to express
    (E2E_r04_discriminate.json caught it)."""
    v = np.asarray(list(values), dtype=np.float64)
    if v.size < 3:
        return [False] * v.size
    med = np.median(v)
    mad = np.median(np.abs(v - med))
    if mad == 0:
        # degenerate spread (e.g. several tied scores): fall back to a ratio
        # test so a merely-better value is not flagged, only wildly
        # disproportionate ones (5x the median)
        if med <= 0:
            return [False] * v.size
        return [bool(x > 5.0 * med) for x in v]
    mz = 0.6745 * (v - med) / mad
    return [bool(z > threshold) for z in mz]
