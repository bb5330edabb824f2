"""Train engine and miner loop — the port of the JAX package's
``engine/train.py`` (``TrainState``, ``default_optimizer``,
``accumulated_grads``, ``TrainEngine``, ``MinerReport``, ``MinerLoop``).

The JAX step is one jitted pure function ``(state, batch) -> (state,
metrics)`` that donates its input state. PyTorch runs eagerly, and the
port updates the state IN PLACE instead: ``train_step`` returns the same
``TrainState`` object, its parameter and moment tensors overwritten, which
is what donation buys XLA (no second copy of params and moments). A caller
that needs the pre-step values (a miner's base snapshot) copies them
first, as the JAX package copies before donating.

The model forward runs through ``torch.func.functional_call`` with the
state's leaf tensors (the spelling of ``model.apply({"params": p}, ...)``),
so the same meta-device GPT-2 structure serves every state and gradients
reach the state's tensors. Attention goes through ``ops.flash_attention``:
the CUDA forward and backward kernels on the card. ``fused_loss=True``
takes the loss from the hidden states through the fused CE kernels
(``ops/fused_ce.py``), so the ``[B, T, V]`` logits never exist.

The optimizer is AdamW computed exactly as ``optax.adamw`` computes it
(``optax.chain(clip_by_global_norm, adamw)`` with ``grad_clip``, and
``mu_dtype="bfloat16"``'s first moment stored in bf16), and its state
carries across from optax's with :func:`opt_state_from_numpy`.

:class:`MinerLoop` is the miner's round on one host: bootstrap from the
published base, train, pull new bases on a cadence (resetting the
optimizer), guard on held-out data, publish ``trained - base`` through
``engine/publish.py`` (as a dense delta or, with ``wire_v2``, as the
packed top-k form with its error-feedback residual), pull bases through
the content-addressed ``engine/basedist.BaseFetcher``, checkpoint locally
(``checkpoint.CheckpointStore``) and resume from it, and profile a
window of steps (``utils/metrics.TraceCapture``, on its own or armed by
``utils/obs.AnomalyMonitor``).

On a mesh (``mesh=``, a ``parallel.Mesh``: one process per device over
``torch.distributed``) the state holds this rank's shards of the
parameters and of Adam's moments (``parallel/sharding.py``). Each step
all-gathers each block's parameters as the block starts and drops them
as it ends, gathering again what the backward needs (ZeRO-3: the
gather's backward sums the gradient over fsdp), feeds the tied head to
the sharded fused CE as its shard, sums the gradients over dp (and over
fsdp where a parameter is not split on it), clips by the global norm
over the shards and updates the shards. On a tp mesh the blocks split
their work Megatron style (``sharding.tp_block_route``, decided here
from the shapes): each rank computes ``H/tp`` heads and ``4E/tp`` MLP
columns from its own tp chunks, each half entering through
``collectives.copy_to`` and leaving through an all-reduce over tp; where
tp does not divide the heads, the attention half runs every head on
gathered parameters. A tp-split leaf's gradient is then this rank's own
slice and takes no sum over tp; a leaf replicated over tp (the
LayerNorms, ``wpe``, the output biases, a gathered attention half)
reaches the same gradient on every tp peer, since copy_to's backward
completes the residual's cotangent. So the sums over dp and fsdp, and
the clip's sum of squares over each leaf's split axes, are unchanged.
On an sp mesh each rank holds its positions of each row
(``sharding.batch_columns``: the targets shifted on the whole row, the
attention's masks whole): the blocks attend over sp by the ring or the
gathered route (``ops.attention.causal_attention``), the loss totals
sum over sp, and every gradient is summed over sp as over dp (its
parameters are replicated there), each sp replica counted once in the
clip's sum of squares. With the model's ``remat`` each block of the
training forward is recomputed in the backward, its parameters gathered
again inside the recomputation on a mesh.
The miner's round on a mesh follows the JAX pod rules: the coordinator
reads the transport and
broadcasts what it read, every rank re-shards, cadence decisions and the
guards' verdicts are the coordinator's, and the coordinator alone
publishes a delta gathered from every rank's shards and writes
checkpoints of the gathered state. Not ported yet, and refused: the
model's dropout and heartbeats (ROADMAP "Slices of the port").
"""

from __future__ import annotations

import dataclasses
import logging
import math
import sys
import time
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from .. import delta as delta_lib
from ..models import (family, init_params_numpy, llama, params_from_numpy,
                      params_to_numpy, resolve_device)
from ..ops.losses import (causal_lm_loss, fused_linear_cross_entropy,
                          lm_totals)
from ..utils import devprof, obs
from ..utils.metrics import device_memory_watermarks, device_metrics
from .basedist import fetch_base
from .scheduler import Clock, PeriodicAction, RealClock

logger = logging.getLogger(__name__)

Params = dict[str, torch.Tensor]

_SLICES = "ROADMAP 'Slices of the port'"


def _devprof_batch_bucket(batch) -> str:
    """``"{B}x{T}"`` of a token batch: the device observatory's bucket of
    the step programs (the JAX package's label)."""
    ids = batch.get("input_ids") if isinstance(batch, dict) else None
    shape = getattr(ids, "shape", None)
    if shape is None or len(shape) < 2:
        return "-"
    return f"{shape[0]}x{shape[1]}"


def _batch_arg_bucket(args, kwargs) -> str:
    """The bucket of a step whose LAST positional argument is the batch
    (``train_step(state, batch)``, ``LoRAEngine.train_step(state, base,
    batch)``)."""
    return _devprof_batch_bucket(args[-1] if args else kwargs.get("batch"))


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState``: the step count and both moments,
    keyed like the params."""
    count: int
    mu: Params
    nu: Params


class AdamW:
    """``optax.adamw(learning_rate, weight_decay=weight_decay)`` (b1 0.9,
    b2 0.999, eps 1e-8, decay on every leaf), optionally after
    ``optax.clip_by_global_norm(grad_clip)``, with optax's formulas and
    rounding points:

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
        p = p - lr u

    (``torch.optim.AdamW`` multiplies p by ``1 - lr wd`` first: the same
    function, other rounding.) The clip is optax's: with
    ``n = sqrt(sum of g^2)``, leaves become ``g / n * max_norm`` unless
    ``n < max_norm`` (``clip_grad_norm_`` adds 1e-6 to n).

    ``mu_dtype`` (``torch.bfloat16``) stores the first moment in that
    dtype, in optax's order: ``b1 mu`` in the stored dtype (a Python
    scalar does not promote, so ``b1`` is rounded to it first), added to
    ``(1 - b1) g`` in f32, the bias correction and the update from that
    f32 moment, and the moment rounded to the stored dtype last."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float = 5e-4, *,
                 weight_decay: float = 0.01,
                 grad_clip: float | None = None,
                 mu_dtype: torch.dtype | None = None):
        self.lr = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.mu_dtype = mu_dtype

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        def zeros(dtype=None):
            return {k: torch.zeros_like(v, dtype=dtype, requires_grad=False)
                    for k, v in params.items()}
        return AdamWState(count=0, mu=zeros(self.mu_dtype), nu=zeros())

    def _clip(self, keys: list[str], grads: list[torch.Tensor],
              sq_sum: Callable | None) -> list[torch.Tensor]:
        sq = [torch.sum(g * g) for g in grads]
        total = sum(sq) if sq_sum is None else sq_sum(dict(zip(keys, sq)))
        norm = torch.sqrt(total)
        keep = norm < self.grad_clip
        return [torch.where(keep, g, g / norm * self.grad_clip)
                for g in grads]

    @torch.no_grad()
    def update_(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
                params: Mapping[str, torch.Tensor], *,
                sq_sum: Callable | None = None) -> None:
        """One step, in place: ``params`` and ``state``'s moments are
        overwritten and its count advances. ``sq_sum`` turns the leaves'
        local sums of squares (``{name: 0-dim}``) into the global one
        (on a mesh, a sum over the ranks holding each leaf's shards)."""
        keys = list(params)
        g = [grads[k] for k in keys]
        if self.grad_clip is not None:
            g = self._clip(keys, g, sq_sum)
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        p = [params[k] for k in keys]
        if self.mu_dtype is None:
            torch._foreach_mul_(mu, self.B1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.B1)
            mu_f = mu
        else:
            b1 = float(torch.tensor(self.B1, dtype=self.mu_dtype))
            mu_f = torch._foreach_mul(g, 1.0 - self.B1)
            torch._foreach_add_(mu_f, [(m * b1).float() for m in mu])
        torch._foreach_mul_(nu, self.B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.B2)
        state.count += 1
        # optax's bias corrections: 1 - decay ** count, in f32
        t = np.float32(state.count)
        bc1 = float(np.float32(1.0) - np.float32(self.B1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(self.B2) ** t)
        # the same operations in place on two temporaries: one copy of
        # the parameters' size each, not four (1.49B f32 parameters at
        # Llama-3-8B's width would hold 24 GB of them at once)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        upd = torch._foreach_div(mu_f, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-self.lr)
        if mu_f is not mu:
            torch._foreach_copy_(mu, mu_f)


def default_optimizer(learning_rate: float = 5e-4, *,
                      grad_clip: float | None = None,
                      weight_decay: float = 0.01,
                      mu_dtype: str | None = None) -> AdamW:
    """AdamW @ 5e-4, weight decay 0.01 by default: the JAX package's
    ``optax.adamw(learning_rate, weight_decay=weight_decay)``;
    ``grad_clip`` chains optax's global-norm clip before it;
    ``mu_dtype`` (``"bfloat16"``) stores the first moment in that dtype,
    as ``optax.adamw(mu_dtype=...)`` does (what lets the 7B/8B
    configurations keep params and AdamW resident). The miner's
    ``--learning-rate``, ``--weight-decay``, ``--grad-clip`` and
    ``--mu-dtype``."""
    dtypes = {None: None, "float32": None, "bfloat16": torch.bfloat16}
    if mu_dtype not in dtypes:
        raise ValueError(f"mu_dtype={mu_dtype!r}: expected None, "
                         f"'float32' or 'bfloat16'")
    return AdamW(learning_rate, weight_decay=weight_decay,
                 grad_clip=grad_clip, mu_dtype=dtypes[mu_dtype])


def opt_state_from_numpy(tree: Mapping[str, Any], *, device="cuda"
                         ) -> AdamWState:
    """optax's AdamW state as numpy (``{"count": ..., "mu": tree, "nu":
    tree}``, the moments in the unrolled param-tree layout, as
    ``opt_state[0].count/.mu/.nu`` of ``optax.adamw``) as the port's
    state, on ``device`` (``"cuda"`` unless the caller asks for the
    CPU)."""
    return AdamWState(count=int(np.asarray(tree["count"])),
                      mu=params_from_numpy(tree["mu"], device=device),
                      nu=params_from_numpy(tree["nu"], device=device))


def opt_state_to_numpy(state: AdamWState) -> dict:
    """Inverse of :func:`opt_state_from_numpy`."""
    return {"count": np.int32(state.count),
            "mu": params_to_numpy(state.mu),
            "nu": params_to_numpy(state.nu)}


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: AdamWState


def accumulated_grads(loss_fn: Callable, params: Params, batch: dict,
                      accum_steps: int
                      ) -> tuple[torch.Tensor, torch.Tensor, Params]:
    """``(loss, tokens, grads)`` of ``loss_fn(params, batch) -> (mean,
    count)``, accumulated over ``accum_steps`` microbatches (split along
    the batch dim, which must divide) and weighted by tokens, so the
    result equals the full-batch token mean up to summation order."""
    leaves = list(params.values())
    if accum_steps == 1:
        loss, tokens = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tokens.detach(), dict(zip(params, grads))
    for v in batch.values():
        if v.shape[0] % accum_steps:
            raise ValueError(f"batch dim {v.shape[0]} not divisible by "
                             f"accum_steps={accum_steps}")
    micro = {k: v.chunk(accum_steps) for k, v in batch.items()}
    g_sum = None
    loss_sum = tok_sum = 0.0
    for i in range(accum_steps):
        loss, tokens = loss_fn(params, {k: v[i] for k, v in micro.items()})
        g = torch.autograd.grad(loss * tokens, leaves)
        if g_sum is None:
            g_sum = list(g)
        else:
            torch._foreach_add_(g_sum, g)
        loss_sum = loss_sum + (loss * tokens).detach()
        tok_sum = tok_sum + tokens.detach()
    denom = torch.clamp(tok_sum, min=1.0)
    grads = {k: (g / denom).to(g.dtype) for k, g in zip(params, g_sum)}
    return loss_sum / denom, tok_sum, grads


def _model_kwargs(batch: dict) -> dict:
    return {"attention_mask": batch.get("attention_mask"),
            "segment_ids": batch.get("segment_ids"),
            "position_ids": batch.get("position_ids")}


def _default_lm_loss(model, params: Params, batch: dict):
    logits = torch.func.functional_call(
        model, params, (batch["input_ids"],), _model_kwargs(batch),
        strict=True)
    return causal_lm_loss(logits, batch["input_ids"], batch.get("loss_mask"))


def _mesh_hidden(model, shards: Params, specs: dict, batch: dict, mesh,
                 route: str | None = None, lora=None) -> torch.Tensor:
    """The model's forward to the final hidden states on a mesh, piece
    by piece (ZeRO-3): each block's parameters are gathered as the block
    starts and dropped as it ends, and under ``sharding.regathered``
    what its backward keeps of them stays a shard until the backward
    reads it. Kernels are gathered into the compute dtype the model
    casts them to. On a tp mesh each block computes its share of heads
    and MLP columns by ``route`` (``sharding.tp_block_route``), counted
    in ``sharding.counts``. On an sp mesh the blocks attend over sp, and
    the default positions are this rank's ``index("sp") * T/sp +
    arange(T/sp)``. With ``cfg.remat`` each block runs under
    ``models.gpt2.remat_block``, its parameters gathered inside the
    recomputed region. Either family: GPT-2 embeds ``wte`` + ``wpe``,
    walks ``h_{i}`` and ends in ``ln_f``; a Llama embeds ``wte`` alone,
    walks ``layer_{i}`` (RoPE at the positions) and ends in
    ``final_norm``; in the scan layout each walks its one stacked block
    on the shards' slices ``[i]``. ``lora(name)`` (a LoRA engine's),
    where given, is the whole replicated delta of a block parameter
    (None where it has none): the piece of it that lands on this rank's
    piece of the parameter (``sharding.block_slice``) is added in the
    storage dtype, before the compute cast, as ``models.lora.apply_lora``
    adds it."""
    from ..models.gpt2 import embed_tokens, remat_block
    from ..ops.embed import embed_lookup
    from ..parallel import sharding
    cfg = model.cfg
    is_llama = family(model) is llama

    def gather(block_shards: dict, prefix: str, layer=None) -> dict:
        """The block's parameters from its shards; ``layer`` (the scan
        layout) names the slice ``[layer]`` of stacked shards, whose
        specs then lose their leading layer axis."""
        out = {}
        for k, v in block_shards.items():
            name = prefix + k
            spec = specs[name] if layer is None else specs[name][1:]
            dtype = cfg.compute_dtype() if k.endswith(".kernel") else None
            d = None if lora is None else lora(name)
            if d is None:
                out[k] = sharding.block_param(name, v, mesh, spec, route,
                                              dtype)
                continue
            if layer is not None:
                d = d[layer]
            w = sharding.block_param(name, v, mesh, spec, route)
            w = w + sharding.block_slice(name, d, mesh, spec,
                                         route).to(w.dtype)
            out[k] = w if dtype is None else w.to(dtype)
        return out

    def shards_of(prefix: str) -> dict:
        return {k[len(prefix):]: v for k, v in shards.items()
                if k.startswith(prefix)}

    ids = batch["input_ids"]
    pos = batch.get("position_ids")
    if pos is None and (mesh.size("sp") > 1 or is_llama):
        Tl = ids.shape[1]
        pos = mesh.index("sp") * Tl + torch.arange(Tl, device=ids.device)
    if is_llama:
        pos = pos.expand(ids.shape)
        wte = sharding.gather_param(shards["wte"], mesh, specs["wte"])
        x = embed_lookup(wte, ids).to(cfg.compute_dtype())
        del wte
        layer, final = "layer_", "final_norm"
        args = (batch.get("attention_mask"), batch.get("segment_ids"), pos)
    else:
        wte, wpe = (sharding.gather_param(shards[k], mesh, specs[k])
                    for k in ("wte", "wpe"))
        x = embed_tokens(wte, wpe, ids, pos, cfg)
        del wte, wpe
        layer, final = "h_", "ln_f"
        args = (batch.get("attention_mask"), batch.get("segment_ids"))
    kw = {} if route is None else {"tp": mesh,
                                   "tp_heads": route == "head_split"}
    if mesh.size("sp") > 1:
        kw["sp"] = mesh
    if cfg.scan_blocks:
        # the stacked shards [L, ...] unbound along L: block i computes
        # with slices [i], whose gradients stack back into one
        scan = getattr(model, "layers" if is_llama else "h")
        prefix = ("layers" if is_llama else "h") + ".block."
        per = {k: v.unbind(0) for k, v in shards_of(prefix).items()}
        walk = [(scan.block, prefix, {k: v[i] for k, v in per.items()}, i)
                for i in range(cfg.n_layer)]
    else:
        walk = [(blk, f"{layer}{i}.", shards_of(f"{layer}{i}."), None)
                for i, blk in enumerate(model.blocks())]
    for blk, prefix, block_shards, i in walk:
        if route is not None:
            sharding.counts[f"tp_{route}_blocks"] += 1
        if cfg.remat:
            x, _ = remat_block(
                blk, block_shards, x, *args,
                gather=lambda p, pre=prefix, i=i: gather(p, pre, i), **kw)
        else:
            x, _ = torch.func.functional_call(
                blk, gather(block_shards, prefix, i), (x, *args), kw,
                strict=True)
    return torch.func.functional_call(
        getattr(model, final), gather(shards_of(final + "."), final + "."),
        (x,), strict=True)


def _head(shards: Params) -> str:
    """The name of the head the loss reads: a Llama's untied
    ``lm_head``, else GPT-2's tied ``wte``."""
    return "lm_head" if "lm_head" in shards else "wte"


def _mesh_targets(batch: dict, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """``(labels, label_mask)`` aligned to this rank's positions: the
    batch's own (``sharding.batch_columns`` shifted them on the whole
    row), or, where the rank holds whole rows (sp 1), shifted here."""
    from ..parallel.sharding import shift_labels
    if "labels" not in batch and mesh.size("sp") > 1:
        raise ValueError(
            "an sp rank's batch needs the targets of its whole rows: cut "
            "it with parallel.sharding.batch_rows or batch_columns")
    b = shift_labels(batch)
    return b["labels"], b["label_mask"]


def _mesh_lm_loss(model, shards: Params, specs: dict, batch: dict, mesh,
                  route: str | None = None, lora=None):
    """:func:`_default_lm_loss` on a mesh: this rank's rows and
    positions against the targets of JAX's mesh spelling
    (:func:`_mesh_targets`, the last column of each row masked out
    instead of sliced off, so an sp chunk's last position predicts the
    next chunk's first token), totals summed over dp x fsdp x sp (tp
    peers hold the same rows and the same totals), the global token
    mean on every rank."""
    from ..models.gpt2 import tied_logits
    from ..parallel import collectives as coll
    from ..parallel.sharding import DATA_AXES, gather_param
    hidden = _mesh_hidden(model, shards, specs, batch, mesh, route, lora)
    name = _head(shards)
    to_logits = llama.head_logits if family(model) is llama else tied_logits
    logits = to_logits(hidden, gather_param(shards[name], mesh, specs[name]),
                       model.cfg)
    total, count = lm_totals(logits, *_mesh_targets(batch, mesh))
    total = coll.all_reduce(total, mesh, DATA_AXES)
    count = torch.clamp(coll.all_reduce(count, mesh, DATA_AXES), min=1.0)
    return total / count, count


def _mesh_fused_lm_loss(model, shards: Params, specs: dict, batch: dict,
                        mesh, route: str | None = None, lora=None):
    """The JAX mesh spelling of ``_fused_lm_loss``: the hidden states
    keep their ``[B, T, E]`` shape and the shift moves into the labels
    and the mask (:func:`_mesh_targets`); the sharded CE takes an sp
    chunk's positions as more rows, and the head (a Llama's
    ``lm_head``, GPT-2's tied ``wte``) as this rank's shard."""
    hidden = _mesh_hidden(model, shards, specs, batch, mesh, route, lora)
    labels, m = _mesh_targets(batch, mesh)
    return fused_linear_cross_entropy(hidden, shards[_head(shards)], labels,
                                      m, mesh=mesh)


def _fused_lm_loss(model, params: Params, batch: dict):
    """The same contract as :func:`_default_lm_loss` without the
    ``[B, T, V]`` logits: the model returns its hidden states and the
    head (a Llama's ``lm_head``, GPT-2's tied ``wte``) runs tile by tile
    inside the fused CE (the single-device branch of the JAX package's
    ``_fused_lm_loss``)."""
    hidden = torch.func.functional_call(
        model, params, (batch["input_ids"],),
        {**_model_kwargs(batch), "return_hidden": True}, strict=True)
    head = params[_head(params)]
    mask = batch.get("loss_mask")
    return fused_linear_cross_entropy(
        hidden[:, :-1, :], head, batch["input_ids"][:, 1:],
        None if mask is None else mask[:, 1:])


class TrainEngine:
    """The step functions for one model on one device or one rank of a
    mesh, with an AdamW optimizer (``default_optimizer()`` unless given)
    and the causal-LM loss.

    ``model`` is the port's GPT-2 or Llama structure
    (``models.make_model``), on one device or a mesh.
    ``fused_loss=True`` computes the loss from the hidden states through
    the fused CE kernels (``--fused-loss``); the port has one route, so
    the JAX package's string values (``"pallas"``, ``"scan"``) are
    refused. ``accum_steps=N`` splits each batch into N microbatches and
    applies one token-weighted update. ``device`` is where states and
    batches are placed: ``"cuda"`` unless the caller asks for the CPU;
    there is no fallback.

    ``mesh`` (a ``parallel.Mesh``) trains this rank's shards (the module
    docstring). States are built from full trees (:meth:`init_state`,
    :meth:`place_params` cut them with ``sharding.shard_params``) and
    :meth:`gather` reassembles one (a collective). :meth:`place_batch`
    takes this rank's rows, as JAX's multi-process ``place_batch`` takes
    process-local data (``sharding.batch_rows`` cuts them from a global
    batch); the loss and its gradient are the global batch's."""

    def __init__(self, model, *, optimizer: AdamW | None = None, mesh=None,
                 fused_loss: bool = False, accum_steps: int = 1,
                 device="cuda"):
        self.mesh = mesh
        self.specs = None
        self.tp_route = None
        if mesh is not None:
            from ..parallel import sharding
            from ..parallel.mesh import Mesh
            if not isinstance(mesh, Mesh):
                raise TypeError(
                    f"TrainEngine(mesh=...) takes a parallel.Mesh (the "
                    f"port's dp x fsdp x sp x tp mesh over "
                    f"torch.distributed), got {type(mesh).__name__}")
            sd = model.state_dict()
            self.specs = sharding.param_specs(sd)
            self.tp_route = sharding.tp_block_route(model.cfg, mesh)
            for k, v in sd.items():     # raises where an axis does not divide
                sharding.shard_slices(k, tuple(v.shape), self.specs[k],
                                      mesh.shape, mesh.coords)
        if not isinstance(fused_loss, bool):
            raise ValueError(
                f"fused_loss={fused_loss!r}: the port has one fused route; "
                f"pass True or False (the --fused-loss flag)")
        # a Llama config has no dropout field: JAX's reads as 0 there
        dropout = getattr(getattr(model, "cfg", None), "dropout", 0.0)
        if dropout > 0:
            raise NotImplementedError(
                f"dropout={dropout}: the training forward runs without "
                f"dropout (off in every preset); {_SLICES}, slice 7")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.model = model
        self.tx = optimizer or default_optimizer()
        self.fused_loss = fused_loss
        self.accum_steps = accum_steps
        self.device = resolve_device(device)
        # the device observatory (utils/devprof.py): per-(program, BxT)
        # cost and time, a one-branch pass-through until devprof.enable();
        # a LoRA engine's own steps are its train.step and train.eval
        self.train_step = devprof.wrap("train.step", self.train_step,
                                       bucket=_batch_arg_bucket)
        self.eval_step = devprof.wrap("train.eval", self.eval_step,
                                      bucket=_batch_arg_bucket)
        self._full_eval_step = devprof.wrap(
            "train.eval", TrainEngine.eval_step.__get__(self),
            bucket=_batch_arg_bucket)

    def _loss(self, params: Params, batch: dict, lora=None):
        """The loss of ``params`` (this rank's shards on a mesh) on a
        placed batch; ``lora`` is :func:`_mesh_hidden`'s, on a mesh."""
        if self.mesh is not None:
            from ..parallel.sharding import regathered
            fn = _mesh_fused_lm_loss if self.fused_loss else _mesh_lm_loss
            with regathered():
                return fn(self.model, params, self.specs, batch, self.mesh,
                          self.tp_route, lora)
        fn = _fused_lm_loss if self.fused_loss else _default_lm_loss
        return fn(self.model, params, batch)

    # -- state --------------------------------------------------------------
    def place_params(self, params: Mapping[str, Any]) -> Params:
        """An independent copy of ``params`` (a state dict) on the
        engine's device, as the leaves a step trains. The copy matters:
        the step overwrites its state in place. On a mesh, ``params`` is
        the full tree (tensors or host arrays) and the copy this rank's
        shards."""
        return {k: v.requires_grad_() for k, v in self.shard(params).items()}

    def shard(self, tree: Mapping[str, Any]) -> Params:
        """This rank's shards of a full tree, copied onto the engine's
        device without gradients (the tree itself off a mesh)."""
        if self.mesh is None:
            return {k: torch.as_tensor(v).detach().to(self.device,
                                                      copy=True)
                    for k, v in tree.items()}
        from ..parallel.sharding import shard_params
        return shard_params(tree, self.mesh, specs=self.specs,
                            device=self.device)

    def gather(self, shards: Mapping[str, torch.Tensor]) -> Params:
        """The full tree from every rank's shards (a collective on a
        mesh; detached leaves off one)."""
        if self.mesh is None:
            return {k: v.detach() for k, v in shards.items()}
        from ..parallel.sharding import gather_params
        return gather_params(shards, self.mesh, specs=self.specs)

    def local(self, tree: Params) -> Params:
        """What this rank's steps read of a whole tree (a state dict on
        the engine's device): the tree itself off a mesh, or on a mesh
        that splits no parameter (dp alone); else :meth:`shard`'s
        copy."""
        if self.mesh is None or self.mesh.size(("fsdp", "tp")) == 1:
            return tree
        return self.shard(tree)

    def abstract_state(self) -> TrainState:
        """The restore template of a checkpoint's state: the model's
        state dict on the meta device as the params and both moments."""
        return _abstract_state(self.model)

    def init_state(self, params: Mapping[str, torch.Tensor]) -> TrainState:
        """A fresh optimizer around :meth:`place_params` of ``params``."""
        placed = self.place_params(params)
        return TrainState(step=0, params=placed,
                          opt_state=self.tx.init(placed))

    def place_batch(self, batch: Mapping[str, Any]) -> dict:
        """A batch of numpy arrays (or tensors) on the engine's device;
        on a mesh, this rank's rows of the global batch."""
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    # -- steps --------------------------------------------------------------
    def train_step(self, state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        """One optimizer step on a placed batch, in place (see the module
        docstring). Returns ``(state, {"loss", "tokens"})``; the metrics
        stay on the device."""
        loss, tokens, grads = accumulated_grads(
            self._loss, state.params, batch, self.accum_steps)
        sq_sum = None
        if self.mesh is not None:
            self._sum_grads(grads)
            sq_sum = self._global_sq
        self.tx.update_(grads, state.opt_state, state.params, sq_sum=sq_sum)
        state.step += 1
        return state, {"loss": loss, "tokens": tokens}

    @torch.no_grad()
    def _sum_grads(self, grads: Params) -> None:
        """Sum each shard's gradient over the row axes its gather did not
        (dp, and fsdp where the parameter is not split on it): one
        all-reduce of the flattened leaves for each set of axes."""
        from ..parallel import collectives as coll
        from ..parallel.sharding import grad_sum_axes
        buckets: dict[tuple, list[str]] = {}
        for k in grads:
            axes = tuple(a for a in grad_sum_axes(self.specs[k])
                         if self.mesh.size(a) > 1)
            if axes:
                buckets.setdefault(axes, []).append(k)
        for axes in sorted(buckets):
            keys = buckets[axes]
            flat = torch.cat([grads[k].reshape(-1) for k in keys])
            coll.all_reduce_(flat, self.mesh, axes)
            for k, part in zip(keys, flat.split([grads[k].numel()
                                                 for k in keys])):
                grads[k] = part.view_as(grads[k])

    def _global_sq(self, sq: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The global sum of squares from the leaves' local ones: each
        leaf summed over the axes its shards split (fsdp and/or tp) and
        no others, since dp and sp replicas (and peers along an axis the
        leaf is not split on) hold the same values: each replica counts
        once."""
        from ..parallel import collectives as coll
        from ..parallel.sharding import spec_axes
        buckets: dict[tuple, list[torch.Tensor]] = {}
        for k, v in sq.items():
            axes = tuple(a for a in spec_axes(self.specs[k])
                         if self.mesh.size(a) > 1)
            buckets.setdefault(axes, []).append(v)
        total = None
        for axes in sorted(buckets):
            part = torch.stack(buckets[axes]).sum()
            if axes:
                coll.all_reduce_(part, self.mesh, axes)
            total = part if total is None else total + part
        return total

    @torch.no_grad()
    def eval_step(self, params: Params, batch: dict
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(loss * tokens, tokens)``, weighted for exact aggregation."""
        loss, tokens = self._loss(params, batch)
        return loss * tokens, tokens

    def evaluate(self, params: Params, batches: Iterable[dict]
                 ) -> tuple[float, float]:
        """``(mean loss, perplexity)`` over an eval set, token-weighted
        across batches; the totals stay on the device until one read at
        the end. On an sp mesh each batch holds whole rows, and this rank
        evaluates its positions (``sharding.batch_columns``)."""
        # the full-params step, also on a LoRA engine (whose own
        # eval_step takes the base beside the adapters)
        return self._evaluate(lambda b: self._full_eval_step(params, b),
                              batches)

    def _evaluate(self, step, batches: Iterable[dict]
                  ) -> tuple[float, float]:
        """:meth:`evaluate` of ``step(placed batch) -> (loss * tokens,
        tokens)``."""
        from ..parallel.sharding import batch_columns
        total = count = None
        for batch in batches:
            if self.mesh is not None:
                batch = batch_columns(batch, self.mesh)
            l, c = step(self.place_batch(batch))
            total = l if total is None else total + l
            count = c if count is None else count + c
        if count is None or float(count) == 0:
            return float("nan"), float("nan")
        mean = float(total) / float(count)
        # a wrecked candidate's loss overflows the exponential: infinite
        # perplexity (as JAX's f32 exp gives), never an exception
        return mean, (float("inf") if mean >= 709.0 else math.exp(mean))


# ---------------------------------------------------------------------------
# Pod helpers: the coordinator reads, every rank gets the same value
# ---------------------------------------------------------------------------
#
# Each is a collective: every rank calls it at the same point, and the
# order of the broadcasts inside (a flag or a length first, then the
# payload) keeps the ranks in lockstep. Roles share these; none re-rolls
# the sequence inline.

def mesh_spans(engine) -> bool:
    """True when the engine's mesh has more than one process: the switch
    every role uses to route transport and chain reads through the
    coordinator's broadcasts."""
    mesh = getattr(engine, "mesh", None)
    return mesh is not None and mesh.world_size > 1


def _coordinator() -> bool:
    from ..parallel import multihost
    return multihost.is_coordinator()


def broadcast_flag(flag: bool) -> bool:
    """The coordinator's ``flag``, on every rank."""
    from ..parallel.collectives import broadcast_
    return bool(broadcast_(torch.tensor([int(bool(flag))]))[0])


def all_ranks_agree(flag: bool) -> bool:
    """True on every rank when ``flag`` is True on every rank."""
    import torch.distributed as dist

    from ..parallel.collectives import collective_device
    t = torch.tensor([int(bool(flag))],
                     device=collective_device(dist.get_backend()))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t[0])


def broadcast_optional_bytes(data: bytes | None) -> bytes | None:
    """The coordinator's ``data`` (None: nothing to send) on every rank:
    one length broadcast (-1 for None), then at most one payload."""
    from ..parallel.collectives import broadcast_
    if not _coordinator():
        data = None
    n = int(broadcast_(torch.tensor([-1 if data is None else len(data)],
                                    dtype=torch.int64))[0])
    if n <= 0:
        return None if n < 0 else b""
    buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8)
           if data is not None else torch.empty(n, dtype=torch.uint8))
    return bytes(broadcast_(buf).numpy())


def broadcast_json(obj):
    """The coordinator's JSON-able value on every rank."""
    import json
    data = broadcast_optional_bytes(json.dumps(obj).encode()
                                    if _coordinator() else None)
    return None if data is None else json.loads(data)


def _torch_dtype(ref) -> torch.dtype:
    if isinstance(ref, torch.Tensor):
        return ref.dtype
    return torch.from_numpy(np.zeros(0, dtype=ref.dtype)).dtype


def _broadcast_leaves(template: Mapping, tree) -> dict:
    from ..parallel.collectives import broadcast_
    out = {}
    for k, ref in template.items():
        src = None if tree is None else tree[k]
        if isinstance(ref, Mapping):
            out[k] = _broadcast_leaves(ref, src)
            continue
        dtype = _torch_dtype(ref)
        if src is None:
            buf = torch.empty(tuple(ref.shape), dtype=dtype)
        elif isinstance(src, torch.Tensor):
            buf = src.detach().to("cpu", dtype).contiguous().clone()
        else:
            buf = torch.from_numpy(np.array(src, order="C")).to(dtype)
        out[k] = broadcast_(buf)
    return out


def broadcast_optional_tree(host_template: Mapping, coordinator_fetch
                            ) -> dict | None:
    """``coordinator_fetch()`` runs on the coordinator only (it may
    return None); every rank returns the same tree (host tensors in
    ``host_template``'s layout and dtypes) or the same None: one flag
    broadcast, then one broadcast a leaf."""
    t = coordinator_fetch() if _coordinator() else None
    if not broadcast_flag(t is not None):
        return None
    return _broadcast_leaves(host_template, t)


def coordinator_call(fn, what: str):
    """``fn()`` on the coordinator alone, its JSON-able result on every
    rank. An exception of the coordinator's call is broadcast as a status
    and raised on every rank (a RuntimeError naming ``what``), so the
    ranks fail together and a retry reruns on all of them in lockstep."""
    status, err = None, None
    if _coordinator():
        try:
            status = {"value": fn()}
        except Exception as e:
            status, err = {"error": repr(e)}, e
    status = broadcast_json(status)
    if "error" in status:
        raise RuntimeError(f"the coordinator's {what} failed: "
                           f"{status['error']}") from err
    return status["value"]


def broadcast_metagraph(chain):
    """The coordinator's round-start metagraph, the same on every rank
    (per-miner loops with collectives inside iterate its hotkeys)."""
    from ..chain.base import Metagraph

    def sync():
        m = chain.sync()
        return None if m is None else {"hotkeys": list(m.hotkeys), "uids": list(m.uids),
                "stakes": list(m.stakes), "block": m.block}
    d = coordinator_call(sync, "metagraph sync")
    if d is None:
        raise RuntimeError("the coordinator's metagraph sync was empty")
    return Metagraph(**d)


def stale_submission(transport, hotkey: str, base_revision, *,
                     multi: bool) -> bool:
    """True when ``hotkey``'s delta rider names a base other than
    ``base_revision``. With ``multi`` every rank enters the broadcast and
    the coordinator's verdict counts (a non-coordinator's own read could
    differ, and a local early return would desynchronise the ranks)."""
    def local_verdict() -> bool:
        if base_revision is None:
            return False
        fm = getattr(transport, "fetch_delta_meta", None)
        if fm is None:
            return False
        try:
            meta = fm(hotkey)
        except Exception:
            return False
        if not meta:
            return False
        rev = meta.get("base_revision")
        return rev is not None and rev != base_revision

    if not multi:
        return local_verdict()
    return broadcast_flag(local_verdict() if _coordinator() else False)


def broadcast_base_fetch(transport, host_template: Mapping,
                         current_revision, *, fetch=None):
    """A pod's base pull: the coordinator alone reads the transport
    (``fetch(revision)``, else the monolithic ``fetch_base``), and every
    rank gets the same ``(tree, revision)`` or the same None. An OSError
    of the coordinator's read is raised on every rank, so a bounded
    retry reruns on all of them in lockstep."""
    got, status = None, None
    if _coordinator():
        try:
            rev = transport.base_revision()
            if rev is not None and rev != current_revision:
                got = (fetch(rev) if fetch is not None
                       else transport.fetch_base(host_template))
        except OSError as e:
            status = {"error": repr(e)}
        if status is None:
            status = {"rev": None if got is None else got[1],
                      "found": got is not None}
    status = broadcast_json(status)
    if "error" in status:
        raise OSError(f"the coordinator's base read failed: "
                      f"{status['error']}")
    if not status["found"]:
        return None
    tree = _broadcast_leaves(host_template,
                             got[0] if got is not None else None)
    return tree, status["rev"]


# ---------------------------------------------------------------------------
# The miner's round
# ---------------------------------------------------------------------------

def _snapshot(tree):
    """An independent copy (``.clone()``) of a state dict or a
    :class:`TrainState`: the step overwrites its state in place, so the
    miner's base snapshot and the guard's best state must not alias the
    live tensors."""
    if isinstance(tree, TrainState):
        opt = tree.opt_state
        return TrainState(
            step=tree.step, params={k: v.detach().clone()
                                    for k, v in tree.params.items()},
            opt_state=AdamWState(count=opt.count, mu=_snapshot(opt.mu),
                                 nu=_snapshot(opt.nu)))
    return {k: v.detach().clone() for k, v in tree.items()}


# -- the wire layout ---------------------------------------------------------
# Artifacts (bases, full-parameter deltas, adapters) always travel in the
# unrolled block layout (h_0..h_{L-1}); a --scan-blocks role's stacked
# [L, ...] layout is converted at the transport boundary by the helpers
# below, so the flag is each role's own choice and never the fleet's.

def _scan_wire_adapters(model) -> bool:
    """True when ``model`` runs the scan layout (else its layout is the
    wire layout)."""
    return bool(getattr(getattr(model, "cfg", None), "scan_blocks", False))


def wire_out(engine, tree):
    """The engine's layout -> the wire (unrolled) layout: index views, no
    copies (a nested tree or a state dict; None passes). The identity
    off the scan layout."""
    if tree is None or not _scan_wire_adapters(engine.model):
        return tree
    from ..models import unstack_blocks
    return unstack_blocks(engine.model, tree)


def wire_in(engine, tree):
    """The wire (unrolled) layout -> the engine's layout (stacked under
    ``--scan-blocks``; numpy stays numpy). The identity off the scan
    layout."""
    if tree is None or not _scan_wire_adapters(engine.model):
        return tree
    from ..models import stack_blocks
    return stack_blocks(engine.model, tree)


def _wire_template(model) -> dict:
    """The model's param tree in the wire layout (nested dicts, the JAX
    package's unrolled ``h_{i}`` names, whatever the model's layout)
    with shape-only zero leaves (a broadcast view: no allocation), the
    restore template of every transport read."""
    tree: dict = {}
    sd = model.state_dict()
    if _scan_wire_adapters(model):
        from ..models import unstack_blocks
        sd = unstack_blocks(model, sd)
    for path, t in sd.items():
        *parents, leaf = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.broadcast_to(
            np.zeros((), dtype=str(t.dtype).removeprefix("torch.")),
            tuple(t.shape))
    return tree


@dataclasses.dataclass
class MinerReport:
    steps: int = 0
    pushes: int = 0
    pushes_failed: int = 0       # publish retries exhausted (delta artifact)
    pushes_superseded: int = 0   # async pushes replaced before upload began
    base_pulls: int = 0
    val_reverts: int = 0
    last_loss: float = float("nan")


def _state_finite(state: TrainState) -> torch.Tensor:
    """One 0-dim flag: params and both moments finite (moments can
    overflow a step before the params do), left on the device."""
    trees = (state.params, state.opt_state.mu, state.opt_state.nu)
    return torch.stack([delta_lib.tree_finite(t) for t in trees]).all()


def _abstract_state(model) -> TrainState:
    """A restore template: the model's state dict on the meta device as
    the params and both moments."""
    sd = model.state_dict()
    return TrainState(step=0, params=sd,
                      opt_state=AdamWState(count=0, mu=sd, nu=sd))


class MinerLoop:
    """The miner's round on one host: the port of the JAX package's
    ``MinerLoop`` (the reference's DeltaLoop), around an injected
    transport and clock.

    - bootstrap: pull the published base if there is one, else start
      from ``params`` (or a thunk of them), else a seeded random init;
    - every ``check_update_interval`` seconds, pull a new base and reset
      the optimizer (``keep_optimizer_on_pull`` keeps its moments);
    - with ``val_batches``, every ``val_guard_interval`` seconds score the
      candidate on held-out data, keep the best full state, and revert to
      it after ``val_guard_patience`` consecutive evals worse than the
      best by more than ``val_guard_margin``;
    - every ``send_interval`` seconds publish ``trained - base`` through
      :class:`~.publish.DeltaPublisher` (inline, or on its worker with
      ``push_async``), screened by ``nan_guard``, as f32 or, with
      ``delta_dtype``, as bf16, int8 (``delta.quantize_delta``) or sparse8
      (``delta.sparsify_delta`` at ``delta_density``; both carry no
      residual, and the finite flag is the raw delta's); with ``wire_v2``,
      as the packed
      top-k form (``wire_density``, ``wire_quant``) published as shards
      and a manifest, with an error-feedback residual that carries each
      push's unsent mass into the next (kept only when the delta is
      finite, reset on a base pull);
    - with ``base_fetcher`` (``engine/basedist.BaseFetcher``), base pulls
      fetch only the layers the published manifest changed, falling back
      to the monolithic pull;
    - with ``checkpoint_store``, every ``checkpoint_interval`` seconds
      (and at ``flush``) save params, moments and step (and the base when
      no revision names it; on its worker with ``push_async``), and
      bootstrap resumes from the latest checkpoint, pulling when the base
      moved meanwhile;
    - ``trace`` (``utils/metrics.TraceCapture``) ticks every step;
      ``anomaly`` (``utils/obs.AnomalyMonitor``) sees every step time and,
      at the log cadence, the loss and push counters.

    On a mesh of several processes (``mesh_spans``) the JAX pod rules
    hold: the coordinator alone reads the transport (bases, checkpoints)
    and broadcasts what it read; every rank re-shards; every cadence
    fires on the coordinator's verdict; the guards' verdicts are agreed
    before anyone acts; the delta and checkpoints are gathered from
    every rank's shards, and the coordinator alone publishes and writes
    them. ``heartbeat`` (``engine/health.HeartbeatPublisher``) starts
    with ``run`` (its vitals read this loop's report: host values, never
    a device read) and sends a last beat and closes at ``flush``."""

    def __init__(self, engine: TrainEngine, transport, miner_id: str, *,
                 clock: Clock | None = None,
                 send_interval: float = 800.0,
                 check_update_interval: float = 300.0,
                 metrics=None,
                 log_every: int = 1000,
                 nan_guard: bool = True,
                 delta_dtype: str | None = None,
                 delta_density: float = 1.0 / 64.0,
                 wire_v2: bool = False,
                 wire_density: float = 1.0 / 64.0,
                 wire_quant: str = "int8",
                 val_batches: Callable[[], Iterable[dict]] | None = None,
                 val_guard_interval: float | None = None,
                 val_guard_patience: int = 3,
                 val_guard_margin: float = 0.1,
                 keep_optimizer_on_pull: bool = False,
                 push_async: bool = False,
                 push_queue_depth: int = 1,
                 checkpoint_store=None,
                 checkpoint_interval: float = 600.0,
                 trace=None,
                 anomaly=None,
                 base_fetcher=None,
                 heartbeat=None):
        if delta_dtype not in (None, "float32", "bfloat16", "int8",
                               "sparse8"):
            raise ValueError(f"delta_dtype must be float32, bfloat16, int8 "
                             f"or sparse8, got {delta_dtype!r}")
        if not 0.0 < delta_density <= 1.0:
            raise ValueError(f"delta_density must be in (0, 1], "
                             f"got {delta_density}")
        if wire_v2 and delta_dtype in ("int8", "sparse8"):
            raise ValueError(
                f"wire_v2 replaces the {delta_dtype!r} v1 wire format; "
                "use --wire-density/--wire-quant to tune it instead")
        if not 0.0 < wire_density <= 1.0:
            raise ValueError(f"wire_density must be in (0, 1], "
                             f"got {wire_density}")
        if wire_quant not in delta_lib.WIRE_QUANTS:
            raise ValueError(f"wire_quant must be one of "
                             f"{delta_lib.WIRE_QUANTS}, got {wire_quant!r}")
        from ..transport.retry import DEFAULT_PUBLISH_RETRY
        from .publish import DeltaPublisher
        self.engine = engine
        self.transport = transport
        self.miner_id = miner_id
        self.clock = clock or RealClock()
        self.metrics = metrics
        self.base_fetcher = base_fetcher
        self.checkpoint_store = checkpoint_store
        self.trace = trace
        self.anomaly = anomaly
        # the fleet heartbeat (engine/health.HeartbeatPublisher): started
        # with the loop, a last beat and closed at flush; it times itself
        # on its own thread, the step loop never polls it
        self.heartbeat = heartbeat
        self.log_every = log_every
        self.nan_guard = nan_guard
        self.delta_dtype = None if delta_dtype == "float32" else delta_dtype
        self.delta_density = delta_density
        self.keep_optimizer_on_pull = keep_optimizer_on_pull
        self.push_async = push_async
        self.wire_v2 = wire_v2
        self.wire_density = wire_density
        self.wire_quant = wire_quant
        # the v2 error-feedback residual (a state dict, f32): the mass
        # earlier publishes dropped or rounded, offered again to the next
        # top-k selection; None until the first v2 push and after a pull
        self._wire_residual: Params | None = None
        self.report = MinerReport()
        self._push_seq = 0
        # cap the publish retry loop's total time at the push cadence: a
        # retry loop outliving its own send interval only queues stale
        # supersede work behind a wedged backend
        publish_retry = DEFAULT_PUBLISH_RETRY
        if 0 < send_interval < (publish_retry.max_elapsed or float("inf")):
            publish_retry = dataclasses.replace(publish_retry,
                                                max_elapsed=send_interval)
        self._publisher = DeltaPublisher(
            transport, miner_id, report=self.report, nan_guard=nan_guard,
            queue_depth=push_queue_depth, sleep=self.clock.sleep,
            publish_retry=publish_retry,
            wire_spec=({"format": 2, "density": wire_density,
                        "quant": wire_quant} if wire_v2 else None))
        # the newest step's loss stays on the card until a log boundary
        # or the loop's exit (a per-step read would wait on every step)
        self._last_loss_dev = None
        self._wire_template_cache = None
        self.state: TrainState | None = None
        self.base_params: Params | None = None
        self._base_revision = None
        self._last_base_time = self.clock.now()
        # on a pod every cadence decision is the coordinator's: the
        # actions' bodies hold collectives, and skewed clocks would fire
        # them on some ranks only
        decide = self._synced_decision if self._multi() else None
        self._pull_action = PeriodicAction(check_update_interval,
                                           self._check_pull, self.clock,
                                           decide=decide)
        self._push_action = PeriodicAction(send_interval, self._push_delta,
                                           self.clock, decide=decide)
        self.val_batches = val_batches
        self.val_guard_patience = val_guard_patience
        self.val_guard_margin = val_guard_margin
        self._best_val: float | None = None
        self._best_state: TrainState | None = None
        self._val_strikes = 0
        self._val_guard_action = None
        if val_batches is not None:
            if val_guard_patience < 1:
                raise ValueError(f"val_guard_patience must be >= 1, "
                                 f"got {val_guard_patience}")
            self._val_guard_action = PeriodicAction(
                val_guard_interval if val_guard_interval is not None
                else send_interval, self._val_guard, self.clock,
                decide=decide)
        self._last_ckpt_key = None
        self._ckpt_action = (
            PeriodicAction(checkpoint_interval, self._save_checkpoint,
                           self.clock, decide=decide)
            if checkpoint_store is not None else None)

    # -- multi-process coordination ----------------------------------------
    def _multi(self) -> bool:
        return mesh_spans(self.engine)

    def _synced_decision(self, fire: bool) -> bool:
        """The coordinator's verdict, the same on every rank."""
        return broadcast_flag(fire)

    # -- base model lifecycle ----------------------------------------------
    def _as_state(self, params) -> Params:
        """A state dict from a state dict or a nested (wire-layout) tree;
        on a mesh the full tree stays where it is (the engine cuts this
        rank's shards from it)."""
        if any(isinstance(v, Mapping) for v in params.values()):
            if self.engine.mesh is not None:
                return delta_lib.flatten_tree(params)
            return params_from_numpy(params, device=self.engine.device)
        return params

    def bootstrap(self, params=None, *, seed: int = 0) -> None:
        """Resume from the latest local checkpoint if there is one; else
        pull the published base if one exists; else start from ``params``
        (a state dict or a nested tree in the engine's layout, or a
        zero-argument callable returning one, invoked only on this
        genesis path); else a random init drawn with numpy from
        ``seed``. Fetched bases arrive in the wire layout and are
        converted to the engine's (:func:`wire_in`)."""
        if self._restore_checkpoint():
            if self.base_fetcher is not None:
                # the first pull after a restart then fetches only the
                # layers the fleet moved meanwhile
                base = wire_out(self.engine,
                                self.engine.gather(self.base_params))
                if _coordinator():
                    self.base_fetcher.seed(base)
            return
        if self._multi():
            # the coordinator reads and broadcasts: per-rank reads could
            # see different bases mid-publish and train the pod apart
            fetched = self._fetch_base_broadcast()
        elif self.transport.base_revision() is not None:
            fetched = self._bootstrap_fetch_base()
        else:
            fetched = None
        if fetched is not None:
            base, rev = fetched
            self._base_revision = rev
            self.state = self.engine.init_state(
                self._as_state(wire_in(self.engine, base)))
        else:
            init = params() if callable(params) else params
            if init is None:
                init = init_params_numpy(self.engine.model.cfg, seed)
            self.state = self.engine.init_state(self._as_state(init))
        self.base_params = _snapshot(self.state.params)

    def _bootstrap_fetch_base(self):
        """Boot-time pull of a base the transport SAYS exists. A torn
        mid-publish read must not silently fork this miner to a genesis
        base: retry briefly, then raise OSError so the role's bounded
        bootstrap retry treats it as the transport outage it is."""
        for attempt in range(3):
            fetched = self._fetch_base_single()
            if fetched is not None:
                return fetched
            try:
                if self.transport.base_revision() is None:
                    return None   # base vanished: genuinely no base
            except OSError:
                pass
            if attempt < 2:
                self.clock.sleep(0.2 * (attempt + 1))
        raise OSError("published base unreadable at bootstrap (torn "
                      "publish or partitioned backend); refusing to "
                      "fork to a genesis base")

    def _fetch_base_single(self, revision=None):
        return fetch_base(self.transport, self.base_fetcher,
                          self._wire_template(), revision)

    def _fetch_base_broadcast(self):
        """The coordinator's pull (through the fetcher when one is
        wired), the same ``(tree, revision)`` or None on every rank."""
        return broadcast_base_fetch(self.transport, self._wire_template(),
                                    self._base_revision,
                                    fetch=self._fetch_base_single)

    def _wire_template(self) -> dict:
        if self._wire_template_cache is None:
            self._wire_template_cache = _wire_template(self.engine.model)
        return self._wire_template_cache

    def _check_pull(self) -> None:
        if self._multi():
            fetched = self._fetch_base_broadcast()
        else:
            rev = self.transport.base_revision()
            if rev is None or rev == self._base_revision:
                return
            fetched = self._fetch_base_single(rev)
        if fetched is None:
            return
        params, rev = fetched
        new_params = self._as_state(wire_in(self.engine, params))
        if self.keep_optimizer_on_pull and self.state is not None:
            logger.info("miner %s: new base model %s — keeping optimizer "
                        "moments", self.miner_id, rev and rev[:8])
            self.state = TrainState(
                step=self.state.step,
                params=self.engine.place_params(new_params),
                opt_state=self.state.opt_state)
        else:
            # protocol semantics: optimizer state is discarded on a base
            # update (the reference resets it)
            logger.info("miner %s: new base model %s — resetting optimizer",
                        self.miner_id, rev and rev[:8])
            self.state = self.engine.init_state(new_params)
        self.base_params = _snapshot(self.state.params)
        # a new base restarts the cumulative delta, and with it the
        # residual tracking its unsent mass
        self._wire_residual = None
        self._base_revision = rev
        self._last_base_time = self.clock.now()
        self._reset_val_guard()
        self.report.base_pulls += 1

    # -- self-eval guard ----------------------------------------------------
    def _reset_val_guard(self) -> None:
        """New base => fresh tracking (the old best was relative to the
        superseded base)."""
        self._best_val = None
        self._best_state = None
        self._val_strikes = 0

    def _val_guard(self) -> None:
        if self.state is None or self.val_batches is None:
            return
        loss = self._guard_eval()
        if self._multi():
            loss = float(broadcast_json(loss))   # one verdict for the pod
        if not math.isfinite(loss):
            logger.warning("miner %s: self-eval non-finite, ignoring",
                           self.miner_id)
            return
        if self._best_val is None or loss < self._best_val:
            self._best_val = loss
            self._best_state = _snapshot(self.state)
            self._val_strikes = 0
        elif loss <= self._best_val + self.val_guard_margin:
            # plateau / noise band: CONSECUTIVE over-margin evals only
            self._val_strikes = 0
        else:
            self._val_strikes += 1
            if (self._val_strikes >= self.val_guard_patience
                    and self._best_state is not None):
                logger.info(
                    "miner %s: val loss %.4f exceeded best %.4f by more "
                    "than the %.2f margin for %d consecutive evals — "
                    "reverting to best state (params + optimizer)",
                    self.miner_id, loss, self._best_val,
                    self.val_guard_margin, self._val_strikes)
                # a copy of the kept state: the step overwrites its input
                self.state = _snapshot(self._best_state)
                for v in self.state.params.values():
                    v.requires_grad_()
                self._val_strikes = 0
                self.report.val_reverts += 1
        if self.metrics:
            self.metrics.log({"self_eval_loss": loss,
                              "self_eval_best": self._best_val,
                              "val_reverts": self.report.val_reverts},
                             step=self.report.steps)

    def _guard_eval(self) -> float:
        """The candidate's mean loss on the held-out batches."""
        return self.engine.evaluate(self.state.params, self.val_batches())[0]

    # -- local checkpoints ---------------------------------------------------
    def _checkpoint_base(self):
        """The base to persist: None when a published revision names it
        (it is immutable between pulls and re-fetched on resume); only a
        self-initialised genesis base travels in the snapshot."""
        return None if self._base_revision is not None else self.base_params

    @torch.no_grad()
    def _save_checkpoint(self) -> None:
        if self.checkpoint_store is None or self.state is None:
            return
        from ..checkpoint import Snapshot
        key = (int(self.state.step), self._base_revision)
        if key == self._last_ckpt_key:   # nothing new since the last save
            return
        if self.engine.mesh is not None:
            self._save_gathered_checkpoint(key)
            return
        finite = _state_finite(self.state) if self.nan_guard else None
        if self.push_async:
            # device copies queued on this thread's stream before the next
            # step overwrites the state in place; the flag's read and the
            # write happen on the store's worker (supersede semantics)
            snap = Snapshot(state=_snapshot(self.state),
                            base_params=self._checkpoint_base(),
                            base_revision=self._base_revision,
                            lifetime_steps=self.report.steps)

            def screened(flag=finite) -> bool:
                if flag is None or bool(flag):
                    return True
                # a poisoned state is never saved: resume prefers the
                # checkpoint, so NaNs would wedge the miner across restarts
                logger.warning("miner %s: state non-finite, not "
                               "checkpointing", self.miner_id)
                return False

            self.checkpoint_store.save_async(snap, precondition=screened)
            self._last_ckpt_key = key
            return
        if finite is not None and not bool(finite):
            logger.warning("miner %s: state non-finite, not checkpointing",
                           self.miner_id)
            return
        try:
            self.checkpoint_store.save(
                self.checkpoint_store.next_step(),
                Snapshot(state=self.state,
                         base_params=self._checkpoint_base(),
                         base_revision=self._base_revision,
                         lifetime_steps=self.report.steps))
            self._last_ckpt_key = key
        except Exception:   # a failed save must not kill training
            logger.exception("miner %s: checkpoint save failed",
                             self.miner_id)

    def _save_gathered_checkpoint(self, key) -> None:
        """A mesh's checkpoint: screened on every rank's shards and
        agreed, gathered (a collective), written by the coordinator."""
        from ..checkpoint import Snapshot
        if self.nan_guard:
            ok = bool(_state_finite(self.state))
            if self._multi():
                ok = all_ranks_agree(ok)
            if not ok:
                logger.warning("miner %s: state non-finite, not "
                               "checkpointing", self.miner_id)
                return
        eng, opt = self.engine, self.state.opt_state
        state = TrainState(step=self.state.step,
                           params=eng.gather(self.state.params),
                           opt_state=AdamWState(count=opt.count,
                                                mu=eng.gather(opt.mu),
                                                nu=eng.gather(opt.nu)))
        base = self._checkpoint_base()
        base = None if base is None else eng.gather(base)
        self._last_ckpt_key = key
        if not _coordinator():
            return
        snap = Snapshot(state=state, base_params=base,
                        base_revision=self._base_revision,
                        lifetime_steps=self.report.steps)
        if self.push_async:
            # gathered tensors are fresh: later steps do not touch them
            self.checkpoint_store.save_async(snap)
            return
        try:
            self.checkpoint_store.save(self.checkpoint_store.next_step(),
                                       snap)
        except Exception:   # a failed save must not kill training
            logger.exception("miner %s: checkpoint save failed",
                             self.miner_id)

    def _refetch_base(self, revision):
        """The snapshot's base again, valid only while the transport still
        serves exactly that revision."""
        if revision is None or self.transport.base_revision() != revision:
            return None
        fetched = self._fetch_base_single(revision)
        if fetched is None or fetched[1] != revision:
            return None
        return self._as_state(wire_in(self.engine, fetched[0]))

    def _read_checkpoint(self):
        """``(snapshot, base)`` of the latest local checkpoint (full host
        trees), or None: none saved, unusable, or its base no longer
        published. A corrupt, partial or incompatible checkpoint must
        not wedge the miner: it falls back to the base pull (or the
        genesis init)."""
        from ..checkpoint import Snapshot
        if self.checkpoint_store.latest_step() is None:
            return None
        try:
            meta = self.checkpoint_store.read_meta() or {}
            snap = self.checkpoint_store.restore(Snapshot(
                state=self.engine.abstract_state(),
                base_params=(self.engine.model.state_dict()
                             if meta.get("has_base", True) else None),
                base_revision=None))
            if snap is None:
                logger.warning("miner %s: checkpoint unusable; pulling "
                               "the base instead", self.miner_id)
                return None
            base = snap.base_params
            if base is None:
                # the base must still be at that revision on the
                # transport; otherwise bootstrap pulls the new one
                base = self._refetch_base(snap.base_revision)
                if base is None:
                    logger.info(
                        "miner %s: checkpoint base %s no longer published; "
                        "bootstrapping from the current base", self.miner_id,
                        (snap.base_revision or "?")[:8])
                    return None
        except Exception:
            logger.exception("miner %s: checkpoint restore failed; falling "
                             "back to the base pull", self.miner_id)
            return None
        return snap, base

    def _broadcast_checkpoint(self, got):
        """The coordinator's :meth:`_read_checkpoint`, on every rank."""
        from ..checkpoint import Snapshot
        snap, base = got if got is not None else (None, None)
        meta = broadcast_json(None if snap is None else {
            "step": int(snap.state.step),
            "count": int(snap.state.opt_state.count),
            "base_revision": snap.base_revision,
            "lifetime_steps": snap.lifetime_steps})
        if meta is None:
            return None
        state_tmpl = self.engine.abstract_state().params
        # the base as the checkpoint holds it: the engine's layout
        base_tmpl = self.engine.model.state_dict()
        opt = None if snap is None else snap.state.opt_state
        params, mu, nu, base = (
            _broadcast_leaves(tmpl, None if snap is None else tree)
            for tmpl, tree in (
                (state_tmpl, None if snap is None else snap.state.params),
                (state_tmpl, None if opt is None else opt.mu),
                (state_tmpl, None if opt is None else opt.nu),
                (base_tmpl, base)))
        return Snapshot(
            state=TrainState(step=meta["step"], params=params,
                             opt_state=AdamWState(count=meta["count"],
                                                  mu=mu, nu=nu)),
            base_params=base, base_revision=meta["base_revision"],
            lifetime_steps=meta["lifetime_steps"]), base

    def _restore_checkpoint(self) -> bool:
        if self.checkpoint_store is None:
            return False
        if self._multi():
            # the coordinator reads, every rank re-shards
            got = self._broadcast_checkpoint(
                self._read_checkpoint() if _coordinator() else None)
        else:
            got = self._read_checkpoint()
        if got is None:
            return False
        snap, base = got
        try:
            opt = snap.state.opt_state
            self.state = TrainState(
                step=snap.state.step,
                params=self.engine.place_params(snap.state.params),
                opt_state=AdamWState(
                    count=opt.count, mu=self.engine.shard(opt.mu),
                    nu=self.engine.shard(opt.nu)))
            self.base_params = self.engine.shard(base)
            self._base_revision = snap.base_revision
            self.report.steps = (snap.lifetime_steps
                                 if snap.lifetime_steps is not None
                                 else int(self.state.step))
            self._last_ckpt_key = (int(self.state.step), self._base_revision)
        except Exception:
            logger.exception("miner %s: checkpoint restore failed; falling "
                             "back to the base pull", self.miner_id)
            self.state = None
            self.base_params = None
            self._base_revision = None
            return False
        logger.info("miner %s: resumed from checkpoint at step %d "
                    "(lifetime %d)", self.miner_id, int(self.state.step),
                    self.report.steps)
        # the base may have moved while this miner was down; a probe that
        # fails (the backend still partitioned) must not crash the resume
        multi = self._multi()
        moved = False
        try:
            if _coordinator() or not multi:
                moved = self.transport.base_revision() not in (
                    None, self._base_revision)
            if moved and not multi:
                logger.info("miner %s: base moved while down, pulling",
                            self.miner_id)
                self._check_pull()
        except Exception:
            obs.count("miner.resume_probe_errors")
            logger.warning("miner %s: post-resume base probe failed; "
                           "training from the checkpoint", self.miner_id,
                           exc_info=True)
        # on a pod the pull is a collective: every rank on the
        # coordinator's verdict, outside any one rank's handler
        if multi and broadcast_flag(moved):
            logger.info("miner %s: base moved while down, pulling",
                        self.miner_id)
            self._check_pull()
        return True

    # -- publication --------------------------------------------------------
    @torch.no_grad()
    def _push_snapshot(self):
        """``(payload, finite)``: fresh tensors the later in-place steps do
        not touch (the delta, or with ``wire_v2`` its packed form), and
        the delta's 0-dim finite flag, all queued on the card's stream
        (nothing waits here). The v2 residual advances only where the
        delta is finite: one transient divergence must not poison every
        later publish until the next pull."""
        mode = self.delta_dtype
        d = delta_lib.compute_delta(
            self.state.params, self.base_params,
            wire_dtype=None if mode in ("int8", "sparse8") else mode)
        if self.engine.mesh is not None:
            # every rank's shards of the delta, whole on every rank
            d = self.engine.gather(d)
        # artifacts travel unrolled: the codecs' scales and top-k picks
        # are per wire tensor (per block under the scan layout)
        d = wire_out(self.engine, d)
        finite = delta_lib.tree_finite(d)
        if mode == "int8":
            return delta_lib.quantize_delta(d), finite
        if mode == "sparse8":
            return (delta_lib.sparsify_delta(d, density=self.delta_density),
                    finite)
        if not self.wire_v2:
            return d, finite
        if self._wire_residual is None:
            self._wire_residual = {k: torch.zeros(v.shape,
                                                  dtype=torch.float32,
                                                  device=v.device)
                                   for k, v in d.items()}
        packed, new_res = delta_lib.pack_delta_v2(
            d, density=self.wire_density, quant=self.wire_quant,
            residual=self._wire_residual)
        flag = finite.to(next(iter(d.values())).device)
        self._wire_residual = {k: torch.where(flag, new_res[k], r)
                               for k, r in self._wire_residual.items()}
        return packed, finite

    def _push_delta(self) -> None:
        if self.state is None:
            return
        self._push_seq += 1
        cid = obs.new_delta_id(self.miner_id, self._push_seq)
        with obs.span("push.snapshot", cid=cid):
            # the device observatory's push.snapshot program
            payload, finite = devprof.wrap("push.snapshot",
                                           self._push_snapshot)()
        if not self.nan_guard:
            finite = None
        if self._multi():
            # pod rule: the screen is agreed here, at the loop barrier;
            # only the coordinator publishes (its upload may go to the
            # worker, the screen done)
            if finite is not None and not broadcast_flag(bool(finite)):
                logger.warning("miner %s: delta has non-finite values, "
                               "not pushing", self.miner_id)
                return
            if not _coordinator():
                return
            finite = None
        if self.push_async:
            self._publisher.submit(payload, finite, self._base_revision, cid)
            return
        self._publisher.publish_now(payload, finite, self._base_revision, cid)

    # -- the loop -----------------------------------------------------------
    def run(self, batches: Iterable[dict], *, max_steps: int | None = None
            ) -> MinerReport:
        if self.state is None:
            self.bootstrap()
        if self.heartbeat is not None:
            self.heartbeat.start()   # idempotent across run() calls
        start_steps = self.report.steps  # max_steps bounds *this* call
        batch_iter = iter(batches)
        try:
            while True:
                tw = time.perf_counter()
                try:
                    batch = next(batch_iter)
                except StopIteration:
                    break
                obs.observe("miner.data_wait_ms",
                            (time.perf_counter() - tw) * 1e3)
                if (max_steps is not None
                        and self.report.steps - start_steps >= max_steps):
                    break
                self._pull_action.poll()
                t0 = time.perf_counter()
                m = self._train_one(batch)
                step_ms = (time.perf_counter() - t0) * 1e3
                obs.observe("miner.step_ms", step_ms)
                if self.trace is not None:
                    self.trace.tick()
                if self.anomaly is not None:
                    self.anomaly.observe_step_ms(step_ms)
                    self.anomaly.tick()
                self.report.steps += 1
                self._last_loss_dev = m["loss"]
                if self.metrics and self.report.steps % self.log_every == 0:
                    self.report.last_loss = float(self._last_loss_dev)
                    if self.anomaly is not None:
                        # at the log cadence: the loss is read here anyway
                        self.anomaly.observe_loss(self.report.last_loss)
                        self.anomaly.observe_push_counters(
                            self.report.pushes, self.report.pushes_failed)
                    # the device's memory as gauges at the log cadence
                    # (allocator counters: host reads, no sync)
                    for k, v in device_memory_watermarks().items():
                        obs.gauge(f"device.{k}", v)
                    self.metrics.log(
                        {"train_loss": self.report.last_loss,
                         "staleness_s": (self.clock.now()
                                         - self._last_base_time),
                         **device_metrics()},
                        step=self.report.steps)
                    obs.flush(self.metrics, step=self.report.steps)
                if self._val_guard_action is not None:
                    # before push: a revert must land before publishing
                    self._val_guard_action.poll()
                self._push_action.poll()
                if self._ckpt_action is not None:
                    self._ckpt_action.poll()
        finally:
            # the interrupt path reads report.last_loss too; there a failed
            # read must not replace the exception in flight
            exiting_exceptionally = sys.exc_info()[0] is not None
            if self._last_loss_dev is not None:
                try:
                    self.report.last_loss = float(self._last_loss_dev)
                except Exception:
                    if not exiting_exceptionally:
                        raise
                    logger.warning(
                        "miner %s: final loss read failed during "
                        "exceptional shutdown", self.miner_id, exc_info=True)
        return self.report

    def _train_one(self, batch: dict) -> dict:
        """One step on a host batch; the step's metrics."""
        self.state, m = self.engine.train_step(
            self.state, self.engine.place_batch(batch))
        return m

    def flush(self) -> None:
        """Push a delta (and save a checkpoint, when configured) now, then
        DRAIN the background publisher and the checkpoint worker: the
        final artifact is on the wire before flush returns."""
        self._push_delta()
        self._save_checkpoint()
        self._publisher.flush()
        if self.checkpoint_store is not None:
            self.checkpoint_store.flush()
        if self.trace is not None:
            self.trace.close()
        if self.anomaly is not None:
            self.anomaly.close()
        if self.heartbeat is not None:
            # a last beat with the exit-state counters, then stop
            self.heartbeat.beat_now(wait=True)
            self.heartbeat.close()
        if self.metrics is not None:
            obs.flush(self.metrics, step=self.report.steps)

    def close(self) -> None:
        """Drain and stop the publisher's worker thread."""
        self._publisher.close()
