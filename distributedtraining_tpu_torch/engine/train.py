"""Train engine — the port of the JAX package's ``engine/train.py`` step
engine (``TrainState``, ``default_optimizer``, ``accumulated_grads``,
``TrainEngine``).

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
the CUDA forward and backward kernels on the card.

The optimizer is AdamW computed exactly as ``optax.adamw`` computes it
(``optax.chain(clip_by_global_norm, adamw)`` with ``grad_clip``), and its
state carries across from optax's with :func:`opt_state_from_numpy`.

Not ported yet, and refused: a device mesh (``mesh=``), the fused
cross-entropy (``fused_loss``), ``mu_dtype``, and the model's dropout and
remat (ROADMAP "Slices of the port").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from ..models.gpt2 import params_from_numpy, params_to_numpy, resolve_device
from ..ops.losses import causal_lm_loss

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
    """``optax.adamw(5e-4, weight_decay=0.01)`` (b1 0.9, b2 0.999, eps
    1e-8, decay on every leaf), optionally after
    ``optax.clip_by_global_norm(grad_clip)``, with optax's formulas and
    rounding points:

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
        p = p - lr u

    (``torch.optim.AdamW`` multiplies p by ``1 - lr wd`` first: the same
    function, other rounding.) The clip is optax's: with
    ``n = sqrt(sum of g^2)``, leaves become ``g / n * max_norm`` unless
    ``n < max_norm`` (``clip_grad_norm_`` adds 1e-6 to n)."""

    LR, B1, B2, EPS, WEIGHT_DECAY = 5e-4, 0.9, 0.999, 1e-8, 0.01

    def __init__(self, grad_clip: float | None = None):
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
        torch._foreach_add_(upd, p, alpha=self.WEIGHT_DECAY)
        torch._foreach_add_(p, upd, alpha=-self.LR)


def default_optimizer(*, grad_clip: float | None = None,
                      mu_dtype: str | None = None) -> AdamW:
    """AdamW @ 5e-4, weight decay 0.01: the JAX package's
    ``optax.adamw(5e-4, weight_decay=0.01)``; ``grad_clip`` chains
    optax's global-norm clip before it."""
    if mu_dtype is not None:
        raise NotImplementedError(
            f"mu_dtype={mu_dtype!r} (a low-precision first moment) is not "
            f"ported: {_SLICES}, slice 7 (the 7B/8B configurations)")
    return AdamW(grad_clip)


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


def _default_lm_loss(model, params: Params, batch: dict):
    logits = torch.func.functional_call(
        model, params, (batch["input_ids"],),
        {"attention_mask": batch.get("attention_mask"),
         "segment_ids": batch.get("segment_ids"),
         "position_ids": batch.get("position_ids")}, strict=True)
    return causal_lm_loss(logits, batch["input_ids"], batch.get("loss_mask"))


class TrainEngine:
    """The step functions for one model on one device, with the default
    optimizer and the causal-LM loss.

    ``model`` is the port's GPT-2 structure (``models.gpt2.make_model``).
    ``accum_steps=N`` splits each batch into N microbatches and applies
    one token-weighted update. ``device`` is where states and batches are
    placed: ``"cuda"`` unless the caller asks for the CPU; there is no
    fallback."""

    def __init__(self, model, *, mesh=None, fused_loss: bool | str = False,
                 accum_steps: int = 1, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                f"TrainEngine(mesh=...): sharded training is the parallel "
                f"slice, {_SLICES}, slice 7")
        if fused_loss:
            raise NotImplementedError(
                f"fused_loss (--fused-loss and its pallas_ce kernels) is the "
                f"next slice, {_SLICES}, slice 3")
        cfg = getattr(model, "cfg", None)
        if cfg is not None and (cfg.dropout > 0 or cfg.remat):
            raise NotImplementedError(
                f"dropout={cfg.dropout}, remat={cfg.remat}: the training "
                f"forward runs without dropout and rematerialisation "
                f"(both off in every preset); {_SLICES}, slice 3")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.model = model
        self.tx = default_optimizer()
        self.accum_steps = accum_steps
        self.device = resolve_device(device)

    def _loss(self, params: Params, batch: dict):
        return _default_lm_loss(self.model, params, batch)

    # -- state --------------------------------------------------------------
    def init_state(self, params: Mapping[str, torch.Tensor]) -> TrainState:
        """A fresh optimizer around an independent copy of ``params`` (a
        state dict), placed on the engine's device. The copy matters: the
        step overwrites its state in place."""
        placed = {k: v.detach().to(self.device, copy=True).requires_grad_()
                  for k, v in params.items()}
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
