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
(``optax.chain(clip_by_global_norm, adamw)`` with ``grad_clip``), and its
state carries across from optax's with :func:`opt_state_from_numpy`.

:class:`MinerLoop` is the miner's round on one host: bootstrap from the
published base, train, pull new bases on a cadence (resetting the
optimizer), guard on held-out data, and publish ``trained - base`` through
``engine/publish.py``, as a dense delta or, with ``wire_v2``, as the
packed top-k form with its error-feedback residual. Not ported yet, and
refused: a device mesh (``mesh=``), ``mu_dtype``, the model's dropout and
remat, and the miner's int8/sparse8 deltas, checkpoints,
content-addressed base fetches, heartbeats, traces and anomaly captures
(ROADMAP "Slices of the port").
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
from ..models.gpt2 import (init_params_numpy, params_from_numpy,
                           params_to_numpy, resolve_device)
from ..ops import fused_ce
from ..ops.losses import causal_lm_loss, fused_linear_cross_entropy
from ..utils import obs
from .scheduler import Clock, PeriodicAction, RealClock

logger = logging.getLogger(__name__)

Params = dict[str, torch.Tensor]

_SLICES = "ROADMAP 'Slices of the port'"


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
    ``n < max_norm`` (``clip_grad_norm_`` adds 1e-6 to n)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float = 5e-4, *,
                 weight_decay: float = 0.01,
                 grad_clip: float | None = None):
        self.lr = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        zeros = lambda: {k: torch.zeros_like(v, requires_grad=False)  # noqa
                         for k, v in params.items()}
        return AdamWState(count=0, mu=zeros(), nu=zeros())

    def _clip(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.grad_clip
        return [torch.where(keep, g, g / norm * self.grad_clip)
                for g in grads]

    @torch.no_grad()
    def update_(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
                params: Mapping[str, torch.Tensor]) -> None:
        """One step, in place: ``params`` and ``state``'s moments are
        overwritten and its count advances."""
        keys = list(params)
        g = [grads[k] for k in keys]
        if self.grad_clip is not None:
            g = self._clip(g)
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        p = [params[k] for k in keys]
        torch._foreach_mul_(mu, self.B1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.B1)
        torch._foreach_mul_(nu, self.B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.B2)
        state.count += 1
        # optax's bias corrections: 1 - decay ** count, in f32
        t = np.float32(state.count)
        bc1 = float(np.float32(1.0) - np.float32(self.B1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(self.B2) ** t)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.EPS)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-self.lr)


def default_optimizer(learning_rate: float = 5e-4, *,
                      grad_clip: float | None = None,
                      weight_decay: float = 0.01,
                      mu_dtype: str | None = None) -> AdamW:
    """AdamW @ 5e-4, weight decay 0.01 by default: the JAX package's
    ``optax.adamw(learning_rate, weight_decay=weight_decay)``;
    ``grad_clip`` chains optax's global-norm clip before it. The miner's
    ``--learning-rate``, ``--weight-decay`` and ``--grad-clip``."""
    if mu_dtype is not None:
        raise NotImplementedError(
            f"mu_dtype={mu_dtype!r} (a low-precision first moment) is not "
            f"ported: {_SLICES}, slice 7 (the 7B/8B configurations)")
    return AdamW(learning_rate, weight_decay=weight_decay,
                 grad_clip=grad_clip)


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


def _fused_lm_loss(model, params: Params, batch: dict):
    """The same contract as :func:`_default_lm_loss` without the
    ``[B, T, V]`` logits: the model returns its hidden states and the
    tied ``wte`` head runs tile by tile inside the fused CE (the
    single-device branch of the JAX package's ``_fused_lm_loss``)."""
    hidden = torch.func.functional_call(
        model, params, (batch["input_ids"],),
        {**_model_kwargs(batch), "return_hidden": True}, strict=True)
    mask = batch.get("loss_mask")
    return fused_linear_cross_entropy(
        hidden[:, :-1, :], params["wte"], batch["input_ids"][:, 1:],
        None if mask is None else mask[:, 1:])


class TrainEngine:
    """The step functions for one model on one device, with an AdamW
    optimizer (``default_optimizer()`` unless given) and the causal-LM
    loss.

    ``model`` is the port's GPT-2 structure (``models.gpt2.make_model``).
    ``fused_loss=True`` computes the loss from the hidden states through
    the fused CE kernels (``--fused-loss``); the port has one route, so
    the JAX package's string values (``"pallas"``, ``"scan"``) are
    refused. ``accum_steps=N`` splits each batch into N microbatches and
    applies one token-weighted update. ``device`` is where states and
    batches are placed: ``"cuda"`` unless the caller asks for the CPU;
    there is no fallback."""

    def __init__(self, model, *, optimizer: AdamW | None = None, mesh=None,
                 fused_loss: bool = False, accum_steps: int = 1,
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                f"TrainEngine(mesh=...): sharded training is the parallel "
                f"slice, {_SLICES}, slice 7")
        if not isinstance(fused_loss, bool):
            raise ValueError(
                f"fused_loss={fused_loss!r}: the port has one fused route; "
                f"pass True or False (the --fused-loss flag)")
        cfg = getattr(model, "cfg", None)
        if cfg is not None and (cfg.dropout > 0 or cfg.remat):
            raise NotImplementedError(
                f"dropout={cfg.dropout}, remat={cfg.remat}: the training "
                f"forward runs without dropout and rematerialisation "
                f"(both off in every preset); {_SLICES}, slice 7")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.model = model
        self.tx = optimizer or default_optimizer()
        self.fused_loss = fused_loss
        self.accum_steps = accum_steps
        self.device = resolve_device(device)
        if fused_loss and cfg is not None and self.device.type == "cuda":
            fused_ce.refuse_width(cfg.n_embd, cfg.compute_dtype())

    def _loss(self, params: Params, batch: dict):
        fn = _fused_lm_loss if self.fused_loss else _default_lm_loss
        return fn(self.model, params, batch)

    # -- state --------------------------------------------------------------
    def place_params(self, params: Mapping[str, torch.Tensor]) -> Params:
        """An independent copy of ``params`` (a state dict) on the
        engine's device, as the leaves a step trains. The copy matters:
        the step overwrites its state in place."""
        return {k: v.detach().to(self.device, copy=True).requires_grad_()
                for k, v in params.items()}

    def init_state(self, params: Mapping[str, torch.Tensor]) -> TrainState:
        """A fresh optimizer around :meth:`place_params` of ``params``."""
        placed = self.place_params(params)
        return TrainState(step=0, params=placed,
                          opt_state=self.tx.init(placed))

    def place_batch(self, batch: Mapping[str, Any]) -> dict:
        """A batch of numpy arrays (or tensors) on the engine's device."""
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
        self.tx.update_(grads, state.opt_state, state.params)
        state.step += 1
        return state, {"loss": loss, "tokens": tokens}

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
        the end."""
        total = count = None
        for batch in batches:
            l, c = self.eval_step(params, self.place_batch(batch))
            total = l if total is None else total + l
            count = c if count is None else count + c
        if count is None or float(count) == 0:
            return float("nan"), float("nan")
        mean = float(total) / float(count)
        return mean, math.exp(mean)


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


def _wire_template(model) -> dict:
    """The model's param tree in the wire layout (nested dicts, the JAX
    package's unrolled ``h_{i}`` names) with shape-only zero leaves (a
    broadcast view: no allocation), the restore template of every
    transport read. The port trains the unrolled layout, so the wire
    layout is its own (``wire_out``/``wire_in`` are the identity)."""
    tree: dict = {}
    for path, t in model.state_dict().items():
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


_NOT_PORTED = {
    "checkpoint_store": "local checkpoints are slice 5",
    "base_fetcher": "the content-addressed base fetch is slice 5",
    "heartbeat": "fleet heartbeats are slice 7",
    "trace": "profiler captures are slice 7",
    "anomaly": "anomaly-armed captures are slice 7",
}


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
      ``delta_dtype="bfloat16"``, as bf16; with ``wire_v2``, as the packed
      top-k form (``wire_density``, ``wire_quant``) published as shards
      and a manifest, with an error-feedback residual that carries each
      push's unsent mass into the next (kept only when the delta is
      finite, reset on a base pull).

    int8/sparse8 deltas, checkpoints, the content-addressed base fetch,
    heartbeats, traces and anomaly captures raise NotImplementedError
    naming their slice; a device mesh is refused by the engine."""

    def __init__(self, engine: TrainEngine, transport, miner_id: str, *,
                 clock: Clock | None = None,
                 send_interval: float = 800.0,
                 check_update_interval: float = 300.0,
                 metrics=None,
                 log_every: int = 1000,
                 nan_guard: bool = True,
                 delta_dtype: str | None = None,
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
                 **unported):
        for name, value in unported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"MinerLoop got an unexpected keyword "
                                f"argument {name!r}")
            if value:
                raise NotImplementedError(
                    f"MinerLoop({name}=...): {_NOT_PORTED[name]} "
                    f"({_SLICES})")
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
        if delta_dtype not in (None, "float32", "bfloat16"):
            raise NotImplementedError(
                f"delta_dtype={delta_dtype!r}: the int8 and sparse8 wire "
                f"deltas are slice 5 ({_SLICES})")
        from ..transport.retry import DEFAULT_PUBLISH_RETRY
        from .publish import DeltaPublisher
        self.engine = engine
        self.transport = transport
        self.miner_id = miner_id
        self.clock = clock or RealClock()
        self.metrics = metrics
        self.log_every = log_every
        self.nan_guard = nan_guard
        self.delta_dtype = None if delta_dtype == "float32" else delta_dtype
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
        self._pull_action = PeriodicAction(check_update_interval,
                                           self._check_pull, self.clock)
        self._push_action = PeriodicAction(send_interval, self._push_delta,
                                           self.clock)
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
                else send_interval, self._val_guard, self.clock)

    # -- base model lifecycle ----------------------------------------------
    def _as_state(self, params) -> Params:
        """A state dict from a state dict or a nested (wire-layout) tree."""
        if any(isinstance(v, Mapping) for v in params.values()):
            return params_from_numpy(params, device=self.engine.device)
        return params

    def bootstrap(self, params=None, *, seed: int = 0) -> None:
        """Pull the published base if one exists; else start from
        ``params`` (a state dict or a nested tree, or a zero-argument
        callable returning one, invoked only on this genesis path); else
        a random init drawn with numpy from ``seed``."""
        fetched = (self._bootstrap_fetch_base()
                   if self.transport.base_revision() is not None else None)
        if fetched is not None:
            base, rev = fetched
            self._base_revision = rev
            self.state = self.engine.init_state(self._as_state(base))
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
            fetched = self.transport.fetch_base(self._wire_template())
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

    def _wire_template(self) -> dict:
        if self._wire_template_cache is None:
            self._wire_template_cache = _wire_template(self.engine.model)
        return self._wire_template_cache

    def _check_pull(self) -> None:
        rev = self.transport.base_revision()
        if rev is None or rev == self._base_revision:
            return
        fetched = self.transport.fetch_base(self._wire_template())
        if fetched is None:
            return
        params, rev = fetched
        new_params = self._as_state(params)
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
        loss, _ = self.engine.evaluate(self.state.params, self.val_batches())
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

    # -- publication --------------------------------------------------------
    @torch.no_grad()
    def _push_snapshot(self):
        """``(payload, finite)``: fresh tensors the later in-place steps do
        not touch (the delta, or with ``wire_v2`` its packed form), and
        the delta's 0-dim finite flag, all queued on the card's stream
        (nothing waits here). The v2 residual advances only where the
        delta is finite: one transient divergence must not poison every
        later publish until the next pull."""
        d = delta_lib.compute_delta(self.state.params, self.base_params,
                                    wire_dtype=self.delta_dtype)
        finite = delta_lib.tree_finite(d)
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
            payload, finite = self._push_snapshot()
        if not self.nan_guard:
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
                self.state, m = self.engine.train_step(
                    self.state, self.engine.place_batch(batch))
                obs.observe("miner.step_ms",
                            (time.perf_counter() - t0) * 1e3)
                self.report.steps += 1
                self._last_loss_dev = m["loss"]
                if self.metrics and self.report.steps % self.log_every == 0:
                    self.report.last_loss = float(self._last_loss_dev)
                    self.metrics.log(
                        {"train_loss": self.report.last_loss,
                         "staleness_s": (self.clock.now()
                                         - self._last_base_time)},
                        step=self.report.steps)
                    obs.flush(self.metrics, step=self.report.steps)
                if self._val_guard_action is not None:
                    # before push: a revert must land before publishing
                    self._val_guard_action.poll()
                self._push_action.poll()
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

    def flush(self) -> None:
        """Push a delta now, then DRAIN the background publisher: the
        final artifact is on the wire before flush returns."""
        self._push_delta()
        self._publisher.flush()
        if self.metrics is not None:
            obs.flush(self.metrics, step=self.report.steps)

    def close(self) -> None:
        """Drain and stop the publisher's worker thread."""
        self._publisher.close()
