"""Collectives along mesh axes — the port of the JAX package's
``parallel/collectives.py``: the training step's differentiable
collectives, and the averager's merge over a miner axis sharded across
the world.

``shard_map``'s ``all_gather``, ``psum_scatter`` and ``psum`` become
``torch.autograd.Function``s over :class:`~.mesh.Mesh` process groups,
each with the transpose ``shard_map``'s AD gives as its backward:

- :func:`all_gather` (tiled, along ``dim``) <-> :func:`reduce_scatter`;
- :func:`all_reduce` of per-rank partials, whose result every rank then
  uses as one replicated value: backward is the identity;
- :func:`copy_to`, the identity on a value replicated over the axes,
  whose cotangents are per-rank partials: backward is the all-reduce
  (how the fused CE completes dh over tp);
- :func:`ring_pass`, ``ppermute`` one step around an axis (to the next
  coordinate, from the previous one): backward passes the cotangent
  the other way (the ring attention's K/V stream).

A set of axes of size 1 has no group, and every collective over it is
the identity. Every backend runs the same calls
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``,
``batch_isend_irecv``);
the route follows the group's backend, never a probe: NCCL takes the
card's tensors as they are, and under gloo (the CPU tests, and ranks
that share one card) a CUDA tensor goes through a pinned host buffer
both ways. :data:`counts` keeps calls and bytes for each (op, backend,
route); a failed collective raises, and nothing catches it.

The averager's merge (JAX ``:34-273``): a stack of M miner deltas along
a leading miner axis, padded to a bucket of the ladder
:data:`MERGE_BUCKETS` rounded to a multiple of the merge axis's size n,
is "sharded over the axis" as ``P(axis)`` shards it: the rank at
coordinate c along the axis keeps slots ``[c k/n, (c+1) k/n)`` on its
device (:class:`ShardedStack`, built by :func:`stack_deltas_sharded`
from only those slots), and ranks that differ only on other axes hold
the same block. :func:`sharded_cohort_merge` (and
:func:`local_merge`, which the meta-learned strategies call under
autograd) take the local partial sum ``sum_i w_i d_i`` in the base's
dtype and one all-reduce over the axis (one buffer for the whole tree),
so the result is replicated as ``out_specs=P()`` makes it; it is
differentiable in the weights (the all-reduce's backward is the
identity). There is one path: the stack is always built at its bucket,
so JAX's full-stack spellings (``psum_weighted_merge``,
``pad_miner_axis`` of the deltas) have no counterpart here. PyTorch compiles nothing: a "compiled"
bucket is a bucket already dispatched, and ``merge.bucket_compiles``
counts the new ones as JAX counts its compiles.
"""

from __future__ import annotations

import collections
import dataclasses

import torch
import torch.distributed as dist

from ..utils import devprof

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


def _raw_ring_pass(x: torch.Tensor, mesh, axis: str, shift: int
                   ) -> torch.Tensor:
    """``x`` sent to the rank ``shift`` coordinates further along
    ``axis`` (cyclically), and what the rank ``shift`` coordinates back
    sent received in its place: one send and one receive a rank, posted
    together (``batch_isend_irecv``), so the ring cannot deadlock."""
    group = mesh.group(axis)
    peers = mesh.peers(axis)
    n, i = len(peers), mesh.index(axis)
    x = x.contiguous()
    staged = _staged(group, x)
    _note("ring_pass", group, x, staged)
    src = _to_host(x) if staged else x
    out = _host_empty(x.shape, x, staged)
    ops = [dist.P2POp(dist.isend, src, peers[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, peers[(i - shift) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(x.device) if staged else out


class _RingPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _raw_ring_pass(x, mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return _raw_ring_pass(g, mesh, axis, -1), None, None


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


def ring_pass(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.ppermute(x, axis, [(i, (i + 1) % n) for i in range(n)])``:
    this rank's ``x`` goes to the next coordinate along ``axis``, and the
    previous coordinate's arrives. Backward: the cotangent passed back
    the other way. Counted in :data:`counts` as ``ring_pass`` (the bytes
    this rank sends)."""
    if mesh.size(axis) == 1:
        return x
    return _RingPass.apply(x, mesh, axis)


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


# ---------------------------------------------------------------------------
# The averager's merge over a sharded miner axis
# ---------------------------------------------------------------------------

# the bucket ladder of the miner axis (JAX ``MERGE_BUCKETS``): a fleet
# whose accepted count wobbles between 5 and 8 lands on one rung;
# beyond the top bucket, multiples of it
MERGE_BUCKETS = (1, 2, 4, 8, 16)

# (mesh, axis, m_pad) buckets already dispatched (mesh None: the
# single-device stacked strategies); a new entry counts in
# merge.bucket_compiles, and merge_bucket pads a target up to one of
# these
_MERGE_BUCKETS_SEEN: set = set()


def reset_merge_cache() -> None:
    """Forget the dispatched buckets (tests)."""
    _MERGE_BUCKETS_SEEN.clear()


def merge_axis(mesh) -> str:
    """The axis the averager shards the miner stack over: the largest
    (ties prefer dp, then fsdp, sp, tp)."""
    order = {"dp": 0, "fsdp": 1, "sp": 2, "tp": 3}
    names = sorted(mesh.shape.keys(), key=lambda n: order.get(n, 9))
    return max(names, key=lambda n: mesh.shape[n])


def merge_bucket(m: int, mesh=None, axis: str | None = None) -> int:
    """The padded miner-axis size for ``m`` accepted deltas: the smallest
    rung of :data:`MERGE_BUCKETS` >= m (multiples of the top rung beyond
    it), rounded up to a multiple of the merge axis's size; a target not
    dispatched yet pads up to the smallest larger bucket that was (JAX's
    default ``prefer_compiled``)."""
    if m < 1:
        raise ValueError(f"merge cohort must hold >= 1 delta, got {m}")
    for b in MERGE_BUCKETS:
        if m <= b:
            target = b
            break
    else:
        big = MERGE_BUCKETS[-1]
        target = ((m + big - 1) // big) * big
    if mesh is not None:
        axis = axis or merge_axis(mesh)
        n = mesh.shape[axis]
        target = ((target + n - 1) // n) * n
    key = (mesh, axis if mesh is not None else None)
    if (*key, target) not in _MERGE_BUCKETS_SEEN:
        bigger = sorted(t for (mk, ak, t) in _MERGE_BUCKETS_SEEN
                        if (mk, ak) == key and t >= target)
        if bigger:
            target = bigger[0]
    return target


def mark_merge_bucket(m_pad: int, mesh=None, axis: str | None = None
                      ) -> bool:
    """Record a bucket as dispatched; True when it was new (counted in
    ``merge.bucket_compiles``)."""
    from ..utils import obs
    key = (mesh, axis if mesh is not None else None, m_pad)
    if key in _MERGE_BUCKETS_SEEN:
        return False
    _MERGE_BUCKETS_SEEN.add(key)
    obs.count("merge.bucket_compiles")
    return True


@dataclasses.dataclass
class ShardedStack:
    """This rank's block of a miner-axis stack of ``m_pad`` slots sharded
    over ``axis``: ``block[key]`` is ``[m_pad // n, *shape]``, slots
    ``start`` to ``start + k_local`` of the padded stack."""
    block: dict
    m_pad: int
    mesh: object
    axis: str

    @property
    def k_local(self) -> int:
        return self.m_pad // self.mesh.size(self.axis)

    @property
    def start(self) -> int:
        return self.mesh.coords[self.axis] * self.k_local


def _slot_range(m_pad: int, mesh, axis: str) -> range:
    n = mesh.size(axis)
    if m_pad % n:
        raise ValueError(f"stack of {m_pad} does not divide the {n}-wide "
                         f"mesh axis {axis!r}")
    k = m_pad // n
    c = mesh.coords[axis]
    return range(c * k, (c + 1) * k)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    import numpy as np
    x = np.ascontiguousarray(x)
    # arrays decoded from msgpack are read-only views of their buffer
    return torch.from_numpy(x if x.flags.writeable else x.copy())


def stack_deltas_sharded(deltas, mesh, axis: str = "dp",
                         target: int | None = None, *,
                         device="cpu") -> ShardedStack:
    """Stack M dense deltas (wire trees or state dicts) along a miner axis
    padded with zero deltas to ``target`` (default: the next multiple of
    the axis's size), keeping only this rank's block, on ``device``: no
    rank reads, places or holds another rank's slots. Each key stacks in
    the dtype its deltas promote to (the merge casts into the base's)."""
    if not deltas:
        raise ValueError("stack_deltas_sharded: empty sequence")
    from ..delta import flatten_tree
    n = mesh.size(axis)
    m = len(deltas)
    target = max(target or 0, ((m + n - 1) // n) * n)
    slots = _slot_range(target, mesh, axis)
    flat = [flatten_tree(d) for d in deltas]
    block = {}
    for k in flat[0]:
        leaves = [_as_tensor(f[k]) for f in flat]
        dtype = leaves[0].dtype
        for x in leaves[1:]:
            dtype = torch.promote_types(dtype, x.dtype)
        block[k] = torch.stack([
            leaves[i].to(device=device, dtype=dtype) if i < m else
            torch.zeros(leaves[0].shape, dtype=dtype, device=device)
            for i in slots])
    return ShardedStack(block, target, mesh, axis)


def local_merge(base, stacked: ShardedStack, weights):
    """``base + sum_i w_i d_i`` over the whole padded stack: this rank's
    partial sum over its block, in the base's dtype (``wv *
    d.astype(b.dtype)``), then one all-reduce over the stack's axis of
    every leaf's partial in one buffer. ``weights`` (``m_pad`` of them,
    or a mapping of such vectors keyed like ``base``: one a tensor) may
    carry gradients; the all-reduce's backward is the identity."""
    mesh, axis = stacked.mesh, stacked.axis
    per_key = isinstance(weights, dict)
    for w in (weights.values() if per_key else (weights,)):
        if len(w) != stacked.m_pad:
            raise ValueError(f"{len(w)} weights for a stack of "
                             f"{stacked.m_pad}")
    lo, hi = stacked.start, stacked.start + stacked.k_local
    partials = {}
    for k, b in base.items():
        d = stacked.block[k]
        w_local = (weights[k] if per_key else weights)[lo:hi]
        wv = w_local.to(device=b.device, dtype=b.dtype).reshape(
            (-1,) + (1,) * (d.ndim - 1))
        partials[k] = (wv * d.to(b.dtype)).sum(0)
    by_dtype: dict = {}
    for k, p in partials.items():
        by_dtype.setdefault(p.dtype, []).append(k)
    out = {}
    for keys in by_dtype.values():
        flat = torch.cat([partials[k].reshape(-1) for k in keys])
        flat = all_reduce(flat, mesh, axis)
        for k, part in zip(keys, flat.split([partials[k].numel()
                                             for k in keys])):
            out[k] = base[k] + part.view_as(base[k])
    return {k: out[k] for k in base}


def sharded_cohort_merge(base, stacked: ShardedStack, weights):
    """``base + sum_i w_i delta_i`` over a stack built at its bucket
    (:func:`stack_deltas_sharded` at :func:`merge_bucket`): the M
    weights padded with zeros to the stack's ``m_pad``, this rank's
    partial sum and one all-reduce (:func:`local_merge`); the result is
    replicated. Each new bucket counts in ``merge.bucket_compiles`` and
    its first dispatch's wall time in ``compile.ms`` (as JAX counts its
    compiles)."""
    import time

    from ..utils import obs
    w = weights if isinstance(weights, torch.Tensor) else \
        torch.as_tensor(weights)
    if len(w) > stacked.m_pad:
        raise ValueError(f"{len(w)} weights for a stack of "
                         f"{stacked.m_pad}")
    w = torch.cat([w, w.new_zeros(stacked.m_pad - len(w))])
    if mark_merge_bucket(stacked.m_pad, stacked.mesh, stacked.axis):
        t0 = time.perf_counter()
        out = _sharded_merge(base, stacked, w)
        obs.observe("compile.ms", (time.perf_counter() - t0) * 1e3)
        return out
    return _sharded_merge(base, stacked, w)


# the device observatory's merge.sharded, bucket the stack's m_pad
_sharded_merge = devprof.wrap("merge.sharded", local_merge,
                              bucket=lambda a, kw: a[1].m_pad)
