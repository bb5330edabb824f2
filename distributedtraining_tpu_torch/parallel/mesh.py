"""Device mesh over ``torch.distributed`` — the port of the JAX package's
``parallel/mesh.py``.

Axes, as in JAX (any may be 1):

- ``dp``:   pure data parallel (replicated params, sharded batch);
- ``fsdp``: data parallel with parameter sharding (ZeRO-3);
- ``sp``:   sequence parallel (the positions of each row split; see
  ``ops/attention.causal_attention`` for its two attention routes);
- ``tp``:   tensor parallel (vocab/mlp/qkv dims of the storage split).

The port runs one process per device. Ranks map to mesh coordinates in
row-major order over ``(dp, fsdp, sp, tp)``, as JAX's CPU fallback lays
the device list out (``np.asarray(devices).reshape(cfg.shape)``), so a
rank's shards are the JAX array's ``addressable_shards`` at the same
coordinates. :class:`Mesh` holds one process group for each set of axes
a collective runs over: each axis alone, the rows ``(dp, fsdp)``, a
parameter's shard group ``(fsdp, tp)``, the axes a gradient is summed
over (``(dp, fsdp, sp)`` and its subsets) and the whole mesh. Axes of
size 1 drop out of a set, so two sets over the same ranks share one
group, and a set whose size is 1 has no group: a collective over it is
the identity.

``MeshConfig``, ``best_mesh_shape``, ``resolve_mesh_config`` and
``_largest_pow2_divisor`` are copies of the JAX functions (pure
arithmetic).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

AXES = ("dp", "fsdp", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.dp, self.fsdp, self.sp, self.tp)

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)


def best_mesh_shape(n_devices: int, *, model_params: int = 0,
                    per_device_memory: int = 16 * 1024**3) -> MeshConfig:
    """Heuristic mesh for N devices: shard params (fsdp) only once the
    model stops fitting replicated; add tp for very large models (Adam's
    state ~16 bytes a param; tp capped at 8)."""
    if n_devices == 1:
        return MeshConfig()
    state_bytes = model_params * 16
    if model_params and state_bytes > per_device_memory * n_devices // 2:
        tp = min(8, _largest_pow2_divisor(n_devices))
        rest = n_devices // tp
        return MeshConfig(fsdp=rest, tp=tp)
    if model_params and state_bytes > per_device_memory // 2:
        return MeshConfig(fsdp=n_devices)
    return MeshConfig(dp=n_devices)


def resolve_mesh_config(*, n_devices: int, dp: int = 0, fsdp: int = 1,
                        sp: int = 1, tp: int = 1, auto: bool = False,
                        model_params: int = 0,
                        dcn_dp: int = 1) -> MeshConfig:
    """CLI mesh spec -> concrete MeshConfig (pure). ``auto=True`` picks
    via :func:`best_mesh_shape` (per granule when ``dcn_dp > 1``);
    otherwise ``dp=0`` means whatever is left after fsdp*sp*tp."""
    if auto:
        if dcn_dp > 1:
            if n_devices % dcn_dp:
                raise ValueError(
                    f"{n_devices} devices not divisible by dcn_dp={dcn_dp}")
            per = best_mesh_shape(n_devices // dcn_dp,
                                  model_params=model_params)
            return dataclasses.replace(per, dp=per.dp * dcn_dp)
        return best_mesh_shape(n_devices, model_params=model_params)
    rest = fsdp * sp * tp
    if dp == 0:
        dp = max(1, n_devices // rest)
    return MeshConfig(dp=dp, fsdp=fsdp, sp=sp, tp=tp)


def _largest_pow2_divisor(n: int) -> int:
    p = 1
    while n % (p * 2) == 0:
        p *= 2
    return p


def rank_coords(rank: int, cfg: MeshConfig) -> dict[str, int]:
    """Mesh coordinates of ``rank`` (row-major over :data:`AXES`)."""
    return dict(zip(AXES, (int(c) for c in np.unravel_index(rank,
                                                            cfg.shape))))


def group_ranks(cfg: MeshConfig, axes: tuple[str, ...]) -> list[list[int]]:
    """Every group of ranks that differ only along ``axes``, each in
    ascending rank order: row-major over ``axes`` in mesh order, so a
    group's rank ``i`` holds chunk ``i`` of an all-gather along them."""
    ids = np.arange(cfg.n_devices).reshape(cfg.shape)
    keep = [AXES.index(a) for a in AXES if a in axes]
    rest = [i for i in range(len(AXES)) if i not in keep]
    moved = np.transpose(ids, rest + keep).reshape(
        -1, math.prod(cfg.shape[i] for i in keep))
    return [sorted(int(r) for r in row) for row in moved]


# the sets of axes the training step runs collectives over
GROUP_AXES = (("dp",), ("fsdp",), ("sp",), ("tp",), ("dp", "fsdp"),
              ("fsdp", "tp"), ("dp", "sp"), ("fsdp", "sp"),
              ("dp", "fsdp", "sp"), AXES)


class Mesh:
    """The ``(dp, fsdp, sp, tp)`` mesh of an initialised
    ``torch.distributed`` world whose size is the mesh's.

    ``rank`` and ``coords`` are this process's; ``size(axes)`` and
    ``index(axes)`` the size of a set of axes and this rank's index
    along it (row-major); ``group(axes)`` the process group over it
    (None where the size is 1) and ``peers(axes)`` its global ranks in
    coordinate order. The groups are created here, in one order on every
    rank, as ``torch.distributed.new_group`` requires."""

    def __init__(self, cfg: MeshConfig):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError(
                "Mesh needs an initialised torch.distributed world "
                "(parallel.multihost.initialize)")
        world = dist.get_world_size()
        if cfg.n_devices != world:
            raise ValueError(f"mesh {cfg.shape} wants {cfg.n_devices} "
                             f"processes, the world has {world}")
        self.cfg = cfg
        self.shape = dict(zip(AXES, cfg.shape))
        self.rank = dist.get_rank()
        self.world_size = world
        self.coords = rank_coords(self.rank, cfg)
        self.backend = dist.get_backend()
        self._groups: dict[tuple[str, ...], tuple] = {}
        for axes in GROUP_AXES:
            key = self._key(axes)
            if not key or key in self._groups:
                continue
            for ranks in group_ranks(cfg, key):
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[key] = (g, ranks)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return AXES

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes) -> int:
        """This rank's row-major index along ``axes`` (mesh order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in AXES:
            if a in axes:
                i = i * self.shape[a] + self.coords[a]
        return i

    def _key(self, axes) -> tuple[str, ...]:
        """``axes`` in mesh order, those of size 1 left out."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in AXES if a in axes and self.shape[a] > 1)

    def _entry(self, axes) -> tuple | None:
        key = self._key(axes)
        if not key:
            return None
        if key not in self._groups:
            raise KeyError(f"no process group over {key}: the mesh holds "
                           f"{sorted(self._groups)}")
        return self._groups[key]

    def group(self, axes):
        entry = self._entry(axes)
        return None if entry is None else entry[0]

    def peers(self, axes) -> list[int]:
        """The global ranks of this rank's group along ``axes``, in
        coordinate order (``[rank]`` where the size is 1)."""
        entry = self._entry(axes)
        return [self.rank] if entry is None else list(entry[1])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"backend={self.backend})")

