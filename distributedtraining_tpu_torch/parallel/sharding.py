"""Logical axes -> mesh placement for the GPT-2 and Llama parameters and
batches — the port of the JAX package's ``parallel/sharding.py``.

The JAX models annotate every parameter with logical axis names
(``nn.with_logical_partitioning``); :data:`DEFAULT_RULES` maps them to
mesh axes. The port's models carry no annotations, so
:data:`GPT2_LOGICAL_AXES` lists the JAX GPT-2's, by parameter name:

    wte       ("vocab", "embed")   models/gpt2.py:232
    wpe       (None, "embed")      :237
    c_attn    ("embed", "qkv")     :145
    c_proj    ("qkv", "embed")     :167
    c_fc      ("embed", "mlp")     :179
    mlp_proj  ("mlp", "embed")     :181

a dense bias takes its kernel's last axis (``:110``), and LayerNorm's
scale and bias are ``("embed",)``. :data:`LLAMA_LOGICAL_AXES` lists the
JAX Llama's:

    wte, lm_head              ("vocab", "embed")  models/llama.py:221, :265
    wq, wk, wv                ("embed", "qkv")    :138-140
    wo                        ("qkv", "embed")    :166
    w_gate, w_up              ("embed", "mlp")    :170-171
    w_down                    ("mlp", "embed")    :172
    attn_norm, mlp_norm, final_norm scale  ("embed",)  :100-103

:func:`param_spec` resolves them to a spec, one mesh axis (or None) a
dim: ``wte`` is ``("tp", "fsdp")``, ``c_attn.kernel`` and ``wq.kernel``
``("fsdp", "tp")``; under the scan layout ``h.block.c_attn.kernel`` is
``(None, "fsdp", "tp")`` (the layer axis replicated), and a block
computes on the slice ``[i]`` of its stacked shards with the spec's
tail (``engine/train._mesh_hidden``), so :func:`block_param`'s fsdp and
tp slices fall on the same axes of a layer as unrolled.

:func:`shard_params` cuts a full tree to one rank's shards: chunk
``coords[axis]`` of each split dim, equal element for element to the JAX
array's ``addressable_shards`` piece at the same mesh coordinates. A dim
that its mesh axis does not divide raises, as JAX's placement does.
:func:`gather_params` is the inverse (a collective). Adam's moments
follow their parameter, as JAX's ``opt_state_shardings`` places them:
they are keyed by the parameter's name, so :func:`param_specs` places
them too. A batch is ``P(("dp", "fsdp"), "sp")``: rows split over
dp x fsdp in coordinate order, each row's positions over sp, tp peers
holding the same rows and positions (:func:`batch_rows`). On an sp mesh
the labels are shifted on the whole row before the cut, as JAX's mesh
spelling of the loss shifts them (the last position of one sp chunk
predicts the first token of the next), and the integer ids that mask
attention (``segment_ids``, ``attention_mask``) stay whole on every sp
rank, since the attention reads the whole row. Parameters are
replicated over sp, so a gradient is summed over sp as over dp
(:func:`grad_sum_axes`).

:func:`gather_param` is the training step's ZeRO-3 gather: the forward
all-gathers a shard over the axes of each split dim, and the backward
sums the gradient over fsdp (a reduce-scatter) and cuts tp's slice
without a sum, since tp peers that compute on a gathered parameter
compute the same rows and so hold the same cotangent. Under
:func:`regathered` the tensors the backward keeps of a gathered
parameter are kept as its shard and gathered again when read.

On a tp mesh the blocks split their work Megatron style
(:func:`tp_block_route`, :func:`block_param`): storage keeps JAX's
specs, and each rank computes with its own tp chunk where that chunk is
its share of the work. ``c_fc`` (``[E, 4E/tp]`` and its bias) and
``mlp_proj`` (``[4E/tp, E]``) are gathered over fsdp only; where tp
divides the heads, so is ``c_proj`` (``[E/tp, E]``: the rows of heads
``[t H/tp, (t+1) H/tp)``, the attention output being head-major), and
``c_attn`` goes through :func:`gather_heads`, since its tp chunk of the
fused q|k|v columns is not whole heads. A Llama's MLP (``w_gate`` and
``w_up`` by column, ``w_down`` by row; SwiGLU's product is elementwise,
so aligned column chunks suffice) splits the same way. Its attention
splits where tp divides the kv heads (and so the query heads): the tp
chunks of ``wq``, ``wk`` and ``wv`` are whole heads in JAX's layout
(``Hq/tp`` query and ``Hkv/tp`` kv heads, and query head ``h`` reads kv
head ``h // (Hq/Hkv)``, so a rank's query heads meet exactly its own kv
heads), and those of ``wo`` their rows; all four are gathered over fsdp
only. Their backward reduce-scatters over fsdp and does nothing over
tp: each rank's gradient is its own slice. Every other parameter, and
the attention half where tp does not divide the heads, is gathered
whole as before.
"""

from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Any, Mapping

import numpy as np
import torch

from . import collectives as coll
from .mesh import AXES

# logical axis -> mesh axis (None = replicated), JAX sharding.py:22-30
DEFAULT_RULES = (
    ("vocab", "tp"),
    ("qkv", "tp"),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("embed", "fsdp"),
    ("batch", ("dp", "fsdp")),
    ("seq", "sp"),
)

# the JAX GPT-2's logical axes, by the last one or two parts of a name
GPT2_LOGICAL_AXES = {
    "wte": ("vocab", "embed"),
    "wpe": (None, "embed"),
    "c_attn.kernel": ("embed", "qkv"),
    "c_attn.bias": ("qkv",),
    "c_proj.kernel": ("qkv", "embed"),
    "c_proj.bias": ("embed",),
    "c_fc.kernel": ("embed", "mlp"),
    "c_fc.bias": ("mlp",),
    "mlp_proj.kernel": ("mlp", "embed"),
    "mlp_proj.bias": ("embed",),
    "scale": ("embed",),      # ln_1, ln_2, ln_f
    "bias": ("embed",),
}

# the JAX Llama's logical axes, by the last one or two parts of a name
LLAMA_LOGICAL_AXES = {
    "wte": ("vocab", "embed"),
    "lm_head": ("vocab", "embed"),
    "wq.kernel": ("embed", "qkv"),
    "wk.kernel": ("embed", "qkv"),
    "wv.kernel": ("embed", "qkv"),
    "wo.kernel": ("qkv", "embed"),
    "w_gate.kernel": ("embed", "mlp"),
    "w_up.kernel": ("embed", "mlp"),
    "w_down.kernel": ("mlp", "embed"),
    "scale": ("embed",),      # attn_norm, mlp_norm, final_norm
}

# the scan layout's leading axis of a stacked block leaf (JAX's
# metadata_params PARTITION_NAME "layers"; no rule names it)
LAYER_AXIS = "layers"

BATCH_SPEC = (("dp", "fsdp"), "sp")
ROW_AXES = BATCH_SPEC[0]
# the axes over which every rank computes on its own part of the batch
# (its rows and its positions) with replicated parameters
DATA_AXES = (*ROW_AXES, "sp")
# [B, T] batch keys every sp rank holds whole (the attention's masks)
WHOLE_ROW_KEYS = ("segment_ids", "attention_mask")

Spec = tuple


def logical_axes(name: str) -> tuple:
    """The JAX model's logical axes of the parameter ``name`` (a state
    dict key such as ``h_0.c_attn.kernel`` or ``layer_0.wq.kernel``),
    from the table of the family the name belongs to. A stacked block
    leaf of the scan layout (``h.block.c_attn.kernel``,
    ``layers.block.wq.kernel``) leads with ``"layers"``, which no rule
    maps: its layer axis is replicated, as JAX's ``nn.scan`` partition
    name leaves it."""
    parts = name.split(".")
    lead = (LAYER_AXIS,) if parts[0] in ("h", "layers") \
        and parts[1:2] == ["block"] else ()
    if len(parts) == 1:
        key = name
    elif parts[-2].startswith("ln_") or parts[-2].endswith("_norm"):
        key = parts[-1]             # a norm's scale (and GPT-2's bias)
    else:
        key = ".".join(parts[-2:])
    for table in (GPT2_LOGICAL_AXES, LLAMA_LOGICAL_AXES):
        if key in table:
            return lead + table[key]
    raise KeyError(f"no logical axes for parameter {name!r}")


def resolve(logical: tuple, rules=DEFAULT_RULES) -> Spec:
    """Flax's ``logical_to_mesh_axes``: each logical name takes the first
    rule naming it whose mesh axes the spec has not used yet."""
    used: set = set()
    out = []
    for name in logical:
        axis = None
        for lname, maxis in rules:
            if lname != name:
                continue
            names = maxis if isinstance(maxis, tuple) else (maxis,)
            if not used.intersection(names):
                axis = maxis
                used.update(names)
                break
        out.append(axis)
    return tuple(out)


def param_spec(name: str, rules=DEFAULT_RULES) -> Spec:
    return resolve(logical_axes(name), rules)


def param_specs(names, rules=DEFAULT_RULES) -> dict[str, Spec]:
    return {k: param_spec(k, rules) for k in names}


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> tuple[str, ...]:
    """The mesh axes a spec splits on, in mesh order."""
    used = {a for e in spec for a in _axes_of(e)}
    return tuple(a for a in AXES if a in used)


def _chunk(shape_of_mesh: Mapping[str, int], coords: Mapping[str, int],
           entry) -> tuple[int, int]:
    """(number of chunks, this rank's chunk) along a dim split on
    ``entry`` (one axis or a tuple of axes, row-major)."""
    n, i = 1, 0
    for a in _axes_of(entry):
        n *= shape_of_mesh[a]
        i = i * shape_of_mesh[a] + coords[a]
    return n, i


def shard_slices(name: str, shape: tuple, spec: Spec,
                 shape_of_mesh: Mapping[str, int],
                 coords: Mapping[str, int]) -> tuple[slice, ...]:
    """The slices of a full ``shape`` that one rank holds; raises
    ValueError where a mesh axis does not divide its dim."""
    out = []
    for d, entry in enumerate(spec):
        n, i = _chunk(shape_of_mesh, coords, entry)
        if shape[d] % n:
            raise ValueError(
                f"{name}: dim {d} of {tuple(shape)} is not divisible by "
                f"{_axes_of(entry)} = {n} (spec {spec})")
        per = shape[d] // n
        out.append(slice(i * per, (i + 1) * per))
    return tuple(out)


def _shard_one(name, value, spec, shape_of_mesh, coords, device):
    sl = shard_slices(name, tuple(value.shape), spec, shape_of_mesh,
                      coords)
    if isinstance(value, torch.Tensor):
        return value.detach()[sl].to(device, copy=True).contiguous()
    return torch.from_numpy(np.array(np.asarray(value)[sl],
                                     order="C")).to(device)


def shard_params(params: Mapping[str, Any], mesh=None, *,
                 specs: Mapping[str, Spec] | None = None,
                 shape_of_mesh: Mapping[str, int] | None = None,
                 coords: Mapping[str, int] | None = None,
                 device="cpu") -> dict[str, torch.Tensor]:
    """This rank's shards of a full flat tree (``{name: array or
    tensor}``) on ``device``. ``mesh`` gives the mesh's shape and this
    rank's coordinates; ``shape_of_mesh`` and ``coords`` name them for
    any rank instead (no process group needed). ``specs`` defaults to
    the specs of the tree's names (either family)."""
    if mesh is not None:
        shape_of_mesh = mesh.shape if shape_of_mesh is None else \
            shape_of_mesh
        coords = mesh.coords if coords is None else coords
    if shape_of_mesh is None or coords is None:
        raise ValueError("shard_params needs a mesh, or shape_of_mesh "
                         "and coords")
    specs = param_specs(params) if specs is None else specs
    return {k: _shard_one(k, v, specs[k], shape_of_mesh, coords, device)
            for k, v in params.items()}


def grad_sum_axes(spec: Spec) -> tuple[str, ...]:
    """The data axes a parameter's gradient is still to be summed over
    after :func:`gather_param`'s backward: dp and sp always, fsdp where
    the parameter is not split on it."""
    split = spec_axes(spec)
    return tuple(a for a in DATA_AXES if a not in split)


def _shift_left(x):
    """``x[:, 1:]`` with a zero column appended (numpy or torch)."""
    if isinstance(x, torch.Tensor):
        return torch.nn.functional.pad(x[:, 1:], (0, 1))
    x = np.asarray(x)
    return np.concatenate([x[:, 1:], np.zeros_like(x[:, :1])], axis=1)


def shift_labels(batch: Mapping[str, Any]) -> dict:
    """Whole rows with the next-token targets of JAX's mesh spelling of
    the loss: ``labels`` (``input_ids`` shifted left) and ``label_mask``
    (``loss_mask``, or ones, shifted left as f32), position t predicting
    token t + 1 and the last column masked out instead of sliced off. A
    batch without ``input_ids``, or with ``labels``, is returned as it
    is."""
    out = dict(batch)
    if "input_ids" not in out or "labels" in out:
        return out
    ids = out["input_ids"]
    mask = out.get("loss_mask")
    if isinstance(ids, torch.Tensor):
        mask = (torch.ones(ids.shape[:2], dtype=torch.float32,
                           device=ids.device) if mask is None
                else torch.as_tensor(mask).float())
    else:
        mask = (np.ones(np.shape(ids)[:2], np.float32) if mask is None
                else np.asarray(mask, np.float32))
    out["labels"] = _shift_left(ids)
    out["label_mask"] = _shift_left(mask)
    return out


def batch_columns(batch: Mapping[str, Any], mesh) -> dict:
    """This rank's positions of whole rows on ``mesh``'s sp axis: every
    ``[B, T, ...]`` value cut along T into sp chunks, chunk
    ``index("sp")``, after :func:`shift_labels` (the targets of the
    whole row); :data:`WHOLE_ROW_KEYS` stay whole. The batch as it is at
    sp 1. Raises ValueError where sp does not divide T, as JAX's ring
    does."""
    n = mesh.size("sp")
    if n == 1:
        return dict(batch)
    i = mesh.index("sp")
    out = shift_labels(batch)
    for k, v in out.items():
        if k in WHOLE_ROW_KEYS:
            continue
        if v.shape[1] % n:
            raise ValueError(f"batch {k!r}: {v.shape[1]} positions are not "
                             f"divisible by sp = {n}")
        per = v.shape[1] // n
        out[k] = v[:, i * per:(i + 1) * per]
    return out


def batch_rows(batch: Mapping[str, Any], mesh) -> dict:
    """This rank's rows and positions of a global batch under
    :data:`BATCH_SPEC`: the batch dim cut into dp x fsdp chunks, chunk
    ``index(("dp", "fsdp"))`` (tp and sp peers hold the same rows), then
    :func:`batch_columns`."""
    n = mesh.size(ROW_AXES)
    i = mesh.index(ROW_AXES)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k!r}: {v.shape[0]} rows are not "
                             f"divisible by dp x fsdp = {n}")
        per = v.shape[0] // n
        out[k] = v[i * per:(i + 1) * per]
    return batch_columns(out, mesh)


def _gather_steps(mesh, spec: Spec, axes=AXES) -> list[tuple[str, int]]:
    """The (axis, dim) all-gathers that rebuild a parameter from its
    shard along ``axes``: each split dim in turn, the minor axis of a
    tuple entry first, axes of size 1 left out. The backward runs them
    reversed."""
    return [(a, d) for d, entry in enumerate(spec)
            for a in reversed(_axes_of(entry))
            if a in axes and mesh.size(a) > 1]


def _gather(shard: torch.Tensor, mesh, spec: Spec, axes=AXES
            ) -> torch.Tensor:
    full = shard
    for axis, d in _gather_steps(mesh, spec, axes):
        full = coll._raw_all_gather(full, mesh.group(axis),
                                    mesh.size(axis), d)
    return full


def _qkv_heads(full: torch.Tensor, mesh) -> torch.Tensor:
    """This tp rank's q, k and v columns of a whole ``c_attn`` leaf (last
    dim 3E): ``j E + [t E/tp, (t+1) E/tp)`` for j = 0, 1, 2, in order."""
    n, t = mesh.size("tp"), mesh.index("tp")
    lead = full.shape[:-1]
    return full.reshape(*lead, 3, n, -1)[..., t, :].reshape(*lead, -1)


def _qkv_spread(g: torch.Tensor, mesh) -> torch.Tensor:
    """The transpose of :func:`_qkv_heads`: ``g`` at this rank's q, k
    and v columns of a zero leaf."""
    n, t = mesh.size("tp"), mesh.index("tp")
    lead = g.shape[:-1]
    out = g.new_zeros(*lead, 3, n, g.shape[-1] // 3)
    out[..., t, :] = g.reshape(*lead, 3, -1)
    return out.reshape(*lead, -1)


def _gather_qkv_heads(shard: torch.Tensor, mesh, spec: Spec
                      ) -> torch.Tensor:
    return _qkv_heads(_gather(shard, mesh, spec), mesh)


# While :func:`regathered` is active: storage pointer of each gathered
# parameter -> (weak reference to it, a function that gathers it again
# from its shard).
_live: dict | None = None

# "saved_as_shard": tensors the backward keeps as their shard instead of
# the gathered parameter; "regathered": their gathers in the backward;
# "tp_head_split_blocks" / "tp_gathered_attn_blocks": block forwards on
# a tp mesh by :func:`tp_block_route` (both split the MLP's columns).
counts: dict = {"saved_as_shard": 0, "regathered": 0,
                "tp_head_split_blocks": 0, "tp_gathered_attn_blocks": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _register(out: torch.Tensor, regather) -> None:
    if _live is not None:
        _live[out.untyped_storage().data_ptr()] = (weakref.ref(out),
                                                   regather)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, mesh, spec, dtype, axes):
        ctx.args = (mesh, spec, shard.dtype, axes)
        full = _gather(shard, mesh, spec, axes).to(dtype)
        _register(full, functools.partial(_gather, shard.detach(), mesh,
                                          spec, axes))
        return full

    @staticmethod
    def backward(ctx, g):
        mesh, spec, dtype, axes = ctx.args
        g = g.to(dtype)
        for axis, d in reversed(_gather_steps(mesh, spec, axes)):
            n = mesh.size(axis)
            if axis == "tp":
                # tp peers hold the same cotangent: keep this slice
                g = g.chunk(n, dim=d)[mesh.index(axis)].contiguous()
            else:
                g = coll._raw_reduce_scatter(g, mesh.group(axis), n, d)
        return g, None, None, None, None


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, mesh, spec, dtype):
        ctx.args = (mesh, spec, shard.dtype)
        local = _gather_qkv_heads(shard, mesh, spec).to(dtype)
        _register(local, functools.partial(_gather_qkv_heads,
                                           shard.detach(), mesh, spec))
        return local

    @staticmethod
    def backward(ctx, g):
        # each storage column gets the gradient of the one tp rank that
        # computed it: the zero-padded leaf reduce-scattered over tp
        mesh, spec, dtype = ctx.args
        g = _qkv_spread(g.to(dtype), mesh)
        for axis, d in reversed(_gather_steps(mesh, spec)):
            g = coll._raw_reduce_scatter(g, mesh.group(axis),
                                         mesh.size(axis), d)
        return g, None, None, None


def _check_spec(spec: Spec) -> None:
    if "sp" in spec_axes(spec) or "dp" in spec_axes(spec):
        raise ValueError(f"gather_param takes fsdp/tp specs, got {spec}")


def gather_param(shard: torch.Tensor, mesh, spec: Spec,
                 dtype: torch.dtype | None = None,
                 axes: tuple[str, ...] = AXES) -> torch.Tensor:
    """The parameter for the forward, gathered along ``axes`` (every
    split axis by default; see the module docstring) and cast to
    ``dtype`` (the shard's by default) after the gather; the backward
    casts the cotangent back before its reduce-scatter."""
    if not _gather_steps(mesh, spec, axes):
        return shard if dtype is None else shard.to(dtype)
    _check_spec(spec)
    return _GatherParam.apply(shard, mesh, spec, dtype or shard.dtype,
                              axes)


def gather_heads(shard: torch.Tensor, mesh, spec: Spec,
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """This tp rank's heads of a ``c_attn`` leaf (kernel ``[E, 3E]``,
    bias ``[3E]``; the last dim split on tp): the leaf gathered over
    fsdp, then over tp, then its q, k and v columns of heads
    ``[t H/tp, (t+1) H/tp)`` (``[..., 3E/tp]``, q|k|v), cast to
    ``dtype``. Backward: the exact transpose, a reduce-scatter over tp
    of the gradient placed at those columns of a zero leaf, then over
    fsdp. Kept as its shard under :func:`regathered`."""
    _check_spec(spec)
    return _GatherHeads.apply(shard, mesh, spec, dtype or shard.dtype)


# block parameters whose tp chunk is this rank's share of the work:
# always (the MLP's columns, GPT-2's and a Llama's), and where tp divides
# the heads (GPT-2's c_proj rows; a Llama's q, k, v heads and wo rows,
# whole heads in storage); GPT-2's fused q|k|v through gather_heads
_TP_MLP = ("c_fc.kernel", "c_fc.bias", "mlp_proj.kernel",
           "w_gate.kernel", "w_up.kernel", "w_down.kernel")
_TP_HEADS = ("c_proj.kernel", "wq.kernel", "wk.kernel", "wv.kernel",
             "wo.kernel")
_TP_QKV = ("c_attn.kernel", "c_attn.bias")


def tp_block_route(heads, mesh) -> str | None:
    """How the blocks compute on ``mesh``'s tp axis, a rule of shapes.
    ``heads`` is a model config, or ``n_head`` (a GPT-2 has as many kv
    heads as heads). None at tp 1 (on gathered parameters);
    ``"head_split"`` where tp divides the kv heads and the heads
    (``Hq/tp`` query heads, their ``Hkv/tp`` kv heads and the MLP's
    columns split a rank); ``"gathered_attn"`` elsewhere (the MLP's
    columns split, the attention over every head on gathered
    parameters)."""
    if isinstance(heads, int):
        n_head = n_kv = heads
    else:
        n_head = heads.n_head
        n_kv = getattr(heads, "n_kv_head", n_head)
    tp = mesh.size("tp")
    if tp == 1:
        return None
    return ("head_split" if n_head % tp == 0 and n_kv % tp == 0
            else "gathered_attn")


def tp_cut(name: str, route: str | None) -> str | None:
    """How a block on ``route`` cuts the parameter ``name`` over tp:
    ``"chunk"`` (its tp chunk of storage), ``"heads"`` (this rank's
    heads of ``c_attn``) or None (the whole parameter)."""
    leaf = ".".join(name.split(".")[-2:])
    if route is None:
        return None
    if leaf in _TP_MLP or (route == "head_split" and leaf in _TP_HEADS):
        return "chunk"
    if route == "head_split" and leaf in _TP_QKV:
        return "heads"
    return None


def block_param(name: str, shard: torch.Tensor, mesh, spec: Spec,
                route: str | None, dtype: torch.dtype | None = None
                ) -> torch.Tensor:
    """The parameter ``name`` as a block on ``route``
    (:func:`tp_block_route`) computes with it on this rank: this rank's
    tp chunk gathered over fsdp alone, this rank's heads of ``c_attn``
    (:func:`gather_heads`), or the whole parameter
    (:func:`gather_param`)."""
    cut = tp_cut(name, route)
    if cut == "chunk":
        return gather_param(shard, mesh, spec, dtype, axes=("fsdp",))
    if cut == "heads":
        return gather_heads(shard, mesh, spec, dtype)
    return gather_param(shard, mesh, spec, dtype)


def block_slice(name: str, full: torch.Tensor, mesh, spec: Spec,
                route: str | None) -> torch.Tensor:
    """The piece of ``full`` (a whole tensor of the parameter ``name``'s
    shape, replicated on every rank: a LoRA delta) that lands on what
    :func:`block_param` gives this rank: its tp chunk, its heads of
    ``c_attn``, or the whole tensor. Differentiable; the gradient of a
    cut piece is this rank's part of the whole one."""
    cut = tp_cut(name, route)
    if cut == "chunk":
        only_tp = {a: (mesh.size(a) if a == "tp" else 1) for a in AXES}
        return full[shard_slices(name, tuple(full.shape), spec, only_tp,
                                 mesh.coords)]
    if cut == "heads":
        return _qkv_heads(full, mesh)
    return full


@torch.no_grad()
def gather_params(shards: Mapping[str, torch.Tensor], mesh, *,
                  specs: Mapping[str, Spec] | None = None
                  ) -> dict[str, torch.Tensor]:
    """The full tree from every rank's shards (a collective: every rank
    calls it and every rank gets the full tree)."""
    specs = param_specs(shards) if specs is None else specs
    return {k: gather_param(v.detach(), mesh, specs[k])
            for k, v in shards.items()}


def _pack(t: torch.Tensor):
    e = _live.get(t.untyped_storage().data_ptr())
    full = None if e is None else e[0]()
    if full is None or full.dtype != t.dtype:
        return t
    counts["saved_as_shard"] += 1
    return (e[1], full.dtype, t.size(), t.stride(), t.storage_offset())


def _unpack(packed):
    if isinstance(packed, torch.Tensor):
        return packed
    regather, dtype, size, stride, offset = packed
    counts["regathered"] += 1
    return regather().to(dtype).as_strided(size, stride, offset)


@contextlib.contextmanager
def regathered():
    """ZeRO-3 for the tensors autograd keeps: inside this context, a
    tensor saved for the backward that is (a view of) a parameter
    :func:`gather_param` or :func:`gather_heads` gathered is kept as its
    shard and gathered again when the backward reads it. A forward that gathers each
    block's parameters as the block starts then holds one block's full
    parameters at a time, not the model's. Every rank runs the same
    graph, so the backward's gathers meet in the same order."""
    global _live
    prev, _live = _live, {}
    try:
        with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
            yield
    finally:
        _live = prev
