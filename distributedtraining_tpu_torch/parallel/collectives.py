"""Collectives of the training step along mesh axes — the training part
of the JAX package's ``parallel/collectives.py`` (its averager merges,
``sharded_cohort_merge`` and the rest, belong to the averager on a mesh,
slice 7b).

``shard_map``'s ``all_gather``, ``psum_scatter`` and ``psum`` become
``torch.autograd.Function``s over :class:`~.mesh.Mesh` process groups,
each with the transpose ``shard_map``'s AD gives as its backward:

- :func:`all_gather` (tiled, along ``dim``) <-> :func:`reduce_scatter`;
- :func:`all_reduce` of per-rank partials, whose result every rank then
  uses as one replicated value: backward is the identity;
- :func:`copy_to`, the identity on a value replicated over the axes,
  whose cotangents are per-rank partials: backward is the all-reduce
  (how the fused CE completes dh over tp).

A set of axes of size 1 has no group, and every collective over it is
the identity. Every backend runs the same calls
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``);
the route follows the group's backend, never a probe: NCCL takes the
card's tensors as they are, and under gloo (the CPU tests, and ranks
that share one card) a CUDA tensor goes through a pinned host buffer
both ways. :data:`counts` keeps calls and bytes for each (op, backend,
route); a failed collective raises, and nothing catches it.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

# (op, backend, route) -> {"calls": n, "bytes": b}; route "direct" or
# "staged" (through host memory). Bytes are the full buffer: the
# gathered output, the reduce-scatter's input, the all-reduced tensor.
counts: dict = collections.defaultdict(lambda: {"calls": 0, "bytes": 0})


def reset_counts() -> None:
    counts.clear()


def _note(op: str, group, t: torch.Tensor, staged: bool) -> None:
    c = counts[(op, dist.get_backend(group), "staged" if staged else
                "direct")]
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()


def _staged(group, t: torch.Tensor) -> bool:
    """A CUDA tensor under gloo goes through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _host_empty(shape, like: torch.Tensor, staged: bool) -> torch.Tensor:
    if staged:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _raw_all_gather(x: torch.Tensor, group, n: int, dim: int
                    ) -> torch.Tensor:
    x = x.contiguous()
    staged = _staged(group, x)
    src = _to_host(x) if staged else x
    # the ranks' chunks one after another along dim 0, as every
    # backend takes them
    flat = _host_empty((n * x.shape[0], *x.shape[1:]), x, staged)
    dist.all_gather_into_tensor(flat, src, group=group)
    out = torch.cat(flat.chunk(n), dim=dim)
    _note("all_gather", group, out, staged)
    return out.to(x.device) if staged else out


def _raw_reduce_scatter(x: torch.Tensor, group, n: int, dim: int
                        ) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"is not divisible by {n}")
    staged = _staged(group, x)
    _note("reduce_scatter", group, x, staged)
    chunks = x.chunk(n, dim=dim)
    stacked = torch.cat(chunks)         # the chunks along dim 0
    src = _to_host(stacked) if staged else stacked
    out = _host_empty(chunks[0].shape, x, staged)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(x.device) if staged else out


def _raw_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    staged = _staged(group, x)
    _note("all_reduce", group, x, staged)
    buf = _to_host(x) if staged else x.contiguous().clone()
    dist.all_reduce(buf, group=group)
    return buf.to(x.device) if staged else buf


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _raw_all_gather(x, mesh.group(axis), mesh.size(axis), dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return (_raw_reduce_scatter(g, mesh.group(axis), mesh.size(axis),
                                    dim),
                None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _raw_reduce_scatter(x, mesh.group(axis), mesh.size(axis),
                                   dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return (_raw_all_gather(g, mesh.group(axis), mesh.size(axis), dim),
                None, None, None)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _raw_all_reduce(x, mesh.group(axes))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return _raw_all_reduce(g, mesh.group(axes)), None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: the
    chunks of ``axis``'s ranks concatenated along ``dim`` in coordinate
    order. Backward: :func:`reduce_scatter` of the cotangent."""
    if mesh.size(axis) == 1:
        return x
    return _AllGather.apply(x, mesh, axis, dim)


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim,
    tiled=True)``: the sum over ``axis``'s ranks, cut along ``dim`` to
    this rank's chunk. Backward: :func:`all_gather`."""
    if mesh.size(axis) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axis, dim)


def all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``jax.lax.psum(x, axes)``: the sum of the ranks' partials, used
    as one replicated value. Backward: the identity."""
    if mesh.size(axes) == 1:
        return x
    return _AllReduce.apply(x, mesh, axes)


def copy_to(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The identity on a value replicated over ``axes`` whose uses on
    each rank are partial: backward sums the cotangents over ``axes``."""
    if mesh.size(axes) == 1:
        return x
    return _CopyTo.apply(x, mesh, axes)


def all_reduce_(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """In-place sum over ``axes`` outside autograd (gradients, norms)."""
    if mesh.size(axes) == 1:
        return x
    with torch.no_grad():
        x.copy_(_raw_all_reduce(x, mesh.group(axes)))
    return x


def collective_device(backend: str) -> torch.device:
    """Where a world-group collective's tensors live: the current card
    under NCCL, the host under gloo."""
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """In-place broadcast of ``t`` from ``src`` over the whole world
    (the pod helpers' primitive); ``t`` may lie on any device."""
    dev = collective_device(dist.get_backend())
    buf = t if t.device == dev else t.to(dev)
    buf = buf.contiguous()
    c = counts[("broadcast", dist.get_backend(),
                "direct" if buf.device == t.device else "staged")]
    c["calls"] += 1
    c["bytes"] += buf.numel() * buf.element_size()
    dist.broadcast(buf, src=src)
    if buf is not t:
        t.copy_(buf)
    return t
