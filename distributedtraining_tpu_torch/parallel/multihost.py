"""One role over several processes — the port of the JAX package's
``parallel/multihost.py`` onto ``torch.distributed``.

The port runs one process per device: ``torchrun --nproc-per-node N``
on one host (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
and ``MASTER_PORT`` in the environment), or the JAX flags by hand:
``--multihost-coordinator host:port`` is the ``init_method``
(``tcp://host:port``), ``--multihost-processes`` the world size and
``--multihost-id`` the rank. The backend is NCCL on the card and gloo on
the CPU; ``DT_DIST_BACKEND`` overrides it (two ranks sharing one card
need gloo: NCCL refuses two ranks on one device). Every collective waits
at most ``timeout_s`` seconds, so a dead rank ends the others' run with
an error instead of a hang.

Only the coordinator (rank 0) talks to the outside world: the gated
transport and chain below turn every other rank's writes into no-ops
(all but a post-mortem bundle), and the miner's round publishes from the
coordinator alone. Data is split by :func:`shard_documents`.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..transport.base import is_pm_id
from .mesh import Mesh, MeshConfig

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 600.0


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device: str = "cuda",
               backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Bring up the ``torch.distributed`` world; returns True when this
    call did (False when it was up already, or for a single process:
    no explicit argument and ``WORLD_SIZE`` unset or 1).

    Arguments left None come from ``torchrun``'s environment. ``device``
    (``"cuda"`` or ``"cpu"``) picks the default backend and, on the
    card, this rank's device (``LOCAL_RANK``, else the rank modulo the
    cards)."""
    if dist.is_initialized():
        return False
    env = os.environ
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if not explicit and int(env.get("WORLD_SIZE", "1")) <= 1:
        return False
    world = int(num_processes if num_processes is not None
                else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env["RANK"])
    backend = (backend or env.get("DT_DIST_BACKEND")
               or ("nccl" if device != "cpu" else "gloo"))
    if device != "cpu":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=_init_method(coordinator_address),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("multihost: rank %d/%d over %s", rank, world, backend)
    return True


def refuse_world(role: str, *, multihost_flags: bool = False) -> None:
    """Raise NotImplementedError when a role that runs as one process
    (the server, the router) was started as several: ``WORLD_SIZE`` > 1
    (``torchrun``) or a ``--multihost-*`` flag. It runs before any
    process group exists, so no copy serves alongside the others."""
    n = int(os.environ.get("WORLD_SIZE") or 1)
    if n > 1 or multihost_flags:
        raise NotImplementedError(
            f"the {role} started as several processes (WORLD_SIZE={n}, "
            f"torchrun or --multihost-*) is not ported: it runs as one "
            f"process; ROADMAP 'Slices of the port', slice 7")


def shutdown() -> None:
    """Tear the world down (a role's exit, when it brought it up)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the one process that owns transport and chain IO."""
    return process_index() == 0


def pod_mesh_config(n: int, *, dp: int = 0, fsdp: int = 1, sp: int = 1,
                    tp: int = 1, dcn_dp: int = 1, nodes: int = 1,
                    node: int | None = None, rank: int = 0) -> MeshConfig:
    """The mesh of :func:`pod_mesh` over ``n`` processes (pure); ``dp=0``
    means whatever is left (``n / (fsdp*sp*tp)``).

    ``dcn_dp > 1`` (JAX ``pod_mesh``'s hybrid layout) declares that the
    outer ``dcn_dp`` groups of the dp axis cross a slower network: dp
    must divide by it, and each granule (one ``dcn_dp``-th of the ranks,
    so fsdp, sp, tp and the inner part of dp inside it) holds contiguous
    ranks. The row-major layout, dp the slowest axis, already lays them
    so. A granule is a node of ``nodes``: on one node (``nodes`` 1) the
    granules are emulated as contiguous blocks of ranks, as JAX's
    single-process mesh emulates them; over several nodes their count
    must be ``dcn_dp`` and ``rank``'s granule its ``node``, else this
    raises (JAX's hybrid mesh raises; it never reshapes quietly)."""
    rest = fsdp * sp * tp
    if dp == 0:
        if n % rest:
            raise ValueError(f"{n} processes not divisible by "
                             f"fsdp*sp*tp={rest}")
        dp = n // rest
    cfg = MeshConfig(dp=dp, fsdp=fsdp, sp=sp, tp=tp)
    if cfg.n_devices != n:
        raise ValueError(f"mesh {cfg} wants {cfg.n_devices} processes, "
                         f"the world has {n}")
    if dcn_dp > 1:
        if dp % dcn_dp:
            raise ValueError(f"dp={dp} not divisible by dcn_dp={dcn_dp}")
        if nodes > 1:
            per = n // dcn_dp
            if nodes != dcn_dp or node != rank // per:
                raise ValueError(
                    f"dcn_dp={dcn_dp} wants one granule a node of "
                    f"{per} ranks: the world has {nodes} nodes, and rank "
                    f"{rank} is on node {node}")
    return cfg


def pod_mesh(*, dp: int = 0, fsdp: int = 1, sp: int = 1, tp: int = 1,
             dcn_dp: int = 1) -> Mesh:
    """The mesh over every process of the world
    (:func:`pod_mesh_config`); the nodes are ``torchrun``'s
    (``LOCAL_WORLD_SIZE`` ranks each, this one on ``GROUP_RANK``), one
    node without them."""
    n = process_count()
    env = os.environ
    local = int(env.get("LOCAL_WORLD_SIZE") or n)
    node = int(env["GROUP_RANK"]) if "GROUP_RANK" in env else None
    return Mesh(pod_mesh_config(n, dp=dp, fsdp=fsdp, sp=sp, tp=tp,
                                dcn_dp=dcn_dp, nodes=max(1, n // local),
                                node=node, rank=process_index()))


def shard_documents(docs, *, process_index: Optional[int] = None,
                    process_count: Optional[int] = None):
    """Round-robin split of a document stream: document ``i`` goes to
    shard ``i % count``. The miner passes its data-parallel index and
    count (sp and tp peers share rows, so they read one shard)."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    if process_count is None:
        process_count = (dist.get_world_size() if dist.is_initialized()
                         else 1)
    for i, doc in enumerate(docs):
        if i % process_count == process_index:
            yield doc


# ---------------------------------------------------------------------------
# Coordinator gating: every rank computes, one talks to the outside world
# ---------------------------------------------------------------------------

class CoordinatorGatedTransport:
    """Reads pass through on every rank; writes (every ``publish*``
    method and ``gc``) run only on the coordinator and return None
    elsewhere, but for a post-mortem bundle (an id for which
    ``transport.base.is_pm_id`` holds): a rank that crashes publishes
    its flight bundle, as every JAX process does. The miner gathers a
    delta before this gate, on every rank (the gather is a
    collective)."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if (name.startswith("publish") or name == "gc") \
                and not is_coordinator():
            return lambda *a, **kw: (attr(*a, **kw)
                                     if a and is_pm_id(a[0]) else None)
        return attr


class CoordinatorGatedChain:
    """Reads pass through; weight emission runs only on the coordinator."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def set_weights(self, *a, **kw):
        if not is_coordinator():
            return None
        return self._inner.set_weights(*a, **kw)


def gate_io(transport, chain):
    """Gate transport and chain when there are several processes; the
    identity for one."""
    if process_count() <= 1:
        return transport, chain
    return CoordinatorGatedTransport(transport), CoordinatorGatedChain(chain)
