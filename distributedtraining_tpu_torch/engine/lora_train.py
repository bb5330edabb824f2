"""LoRA train engine, miner loop and fetch side — the port of the JAX
package's ``engine/lora_train.py`` (``LoRAEngine``, ``LoRAMinerLoop``,
``fetch_delta_any``, ``fetch_delta_any_broadcast`` and the LoRA tail of
``densify_delta_bytes``, whose try-chain is ``engine/ingest.py``'s;
``adapter_template`` is ``models/lora.py``'s).

A LoRA miner trains low-rank adapters on a frozen base and publishes
the adapter tree: at Llama-2-7B and rank 8 that is 8,388,608 values
(33.6 MB in f32) where a dense delta is 27 GB. Validators and averagers
rebuild the dense delta on their side (``models/lora.py``) and score or
merge it as any full-parameter submission.

The step's loss is the engine's task loss (fused or not) of ``base +
(a @ b) * scaling`` through ``torch.func.functional_call``: the base is
an argument of the step and takes no gradient, so its head does not
either, and the fused CE's backward computes dh alone
(``ops/fused_ce.py``). The optimizer is the full engine's (the miner's
``--learning-rate`` and ``--grad-clip``).

On a mesh (JAX ``lora_train.py:38-45``) the frozen base is sharded by
the full engine's specs and the adapters and their moments are
replicated. Each block adds the piece of ``(a @ b) * scaling`` that
lands on this rank's piece of a kernel (``sharding.block_slice``,
after the block's gather, so it follows the tp routes: GPT-2's fused
``c_attn`` heads, a Llama's GQA ``wk``/``wv`` chunks, and the gathered
route's whole kernels). An adapter's gradient is then this rank's rows'
part of it, and of a tp-cut kernel this rank's piece's part: it is
summed over dp, fsdp and sp, and over tp where its kernel is cut there,
before the update; the clip's norm is then the same on every rank.

Protocol semantics follow the full miner's (``engine/train.MinerLoop``):
the same push, pull, guard and checkpoint cadences and the same
finiteness screen before a publish; a new base resets the adapters
(``b = 0``: a zero delta) and their optimizer.
"""

from __future__ import annotations

import logging
from typing import Any, Iterable, Mapping, Optional

import torch

from .. import delta as delta_lib
from ..models import init_params_numpy
from ..models import lora as lora_lib
from ..models.lora import adapter_template
from .train import (AdamWState, MinerLoop, TrainEngine, TrainState,
                    _coordinator, accumulated_grads, wire_in, wire_out)

logger = logging.getLogger(__name__)

Params = dict[str, torch.Tensor]


class LoRAEngine(TrainEngine):
    """The adapter-only train and eval steps: ``train_step(state, base,
    batch)`` and ``eval_step(adapters, base, batch)``, the base an
    argument of the step (a pull swaps it without touching the engine).
    ``state.params`` holds the adapters (``models.lora`` keys, leaves
    that take gradients). ``place_params``, ``shard`` and ``gather``
    take trees that mix base and adapter keys: base keys are cut by the
    full engine's specs on a mesh, adapter keys are replicated; so a
    checkpoint's state and base restore through the full loop's code."""

    def __init__(self, model, lora_cfg: lora_lib.LoRAConfig, *,
                 optimizer=None, mesh=None, fused_loss: bool = False,
                 accum_steps: int = 1, device="cuda"):
        super().__init__(model, optimizer=optimizer, mesh=mesh,
                         fused_loss=fused_loss, accum_steps=accum_steps,
                         device=device)
        self.lora_cfg = lora_cfg
        self.targets = lora_lib.targets(model.state_dict(), lora_cfg)
        if not self.targets:
            raise ValueError(f"no kernel of the model matches "
                             f"{lora_cfg.target_patterns}")
        self._adapter_keys = {f"{k}.{f}" for k in self.targets
                              for f in lora_lib.FACTORS}

    # -- placement ----------------------------------------------------------
    def _split(self, tree: Mapping[str, Any]) -> tuple[dict, dict]:
        base = {k: v for k, v in tree.items() if k not in self._adapter_keys}
        ad = {k: v for k, v in tree.items() if k in self._adapter_keys}
        return base, ad

    def shard(self, tree: Mapping[str, Any]) -> Params:
        """This rank's copy of a tree: base keys cut by the specs on a
        mesh, adapter keys (and their moments) whole."""
        base, ad = self._split(tree)
        out = super().shard(base) if base else {}
        out.update({k: torch.as_tensor(v).detach().to(self.device, copy=True)
                    for k, v in ad.items()})
        return out

    def gather(self, shards: Mapping[str, torch.Tensor]) -> Params:
        """The full tree (a collective on a mesh for the base keys;
        adapter keys are whole on every rank)."""
        base, ad = self._split(shards)
        out = super().gather(base) if base else {}
        out.update({k: v.detach() for k, v in ad.items()})
        return out

    def place_base(self, params: Mapping[str, Any]) -> Params:
        """The frozen base as the steps read it: this rank's shards on a
        mesh, else the tensors themselves on the engine's device (no
        copy where they are there already: the steps never write it,
        and a 7B base is 27 GB)."""
        if self.mesh is not None:
            return super().shard(params)
        return {k: torch.as_tensor(v).detach().to(self.device)
                for k, v in params.items()}

    def init_state(self, key, base=None) -> TrainState:
        """Fresh adapters (``models.lora.init_lora`` from ``key``, a
        ``utils.prng`` key or an int seed, over the model's shapes; the
        base, where given, is not read) and a fresh optimizer."""
        return self.init_state_from(
            lora_lib.init_lora(key, self.model.state_dict(), self.lora_cfg))

    def init_state_from(self, adapters: Mapping[str, Any]) -> TrainState:
        """A fresh train state over an existing adapter tree."""
        placed = self.place_params(adapters)
        return TrainState(step=0, params=placed,
                          opt_state=self.tx.init(placed))

    def abstract_state(self) -> TrainState:
        """The adapter skeleton on the meta device (a checkpoint's
        restore template), Adam's first moment in ``mu_dtype``."""
        r = self.lora_cfg.rank

        def skel(dtype):
            out = {}
            for k, (*lead, fan_in, fan_out) in self.targets.items():
                out[k + ".a"] = torch.empty((*lead, fan_in, r),
                                            dtype=dtype, device="meta")
                out[k + ".b"] = torch.empty((*lead, r, fan_out),
                                            dtype=dtype, device="meta")
            return out

        params = skel(torch.float32)
        mu = skel(getattr(self.tx, "mu_dtype", None) or torch.float32)
        return TrainState(step=0, params=params,
                          opt_state=AdamWState(count=0, mu=mu, nu=params))

    # -- steps --------------------------------------------------------------
    def _lora_loss(self, adapters: Params, base: Params, batch: dict):
        if self.mesh is None:
            return self._loss(lora_lib.apply_lora(base, adapters,
                                                  self.lora_cfg), batch)
        cfg = self.lora_cfg
        return self._loss(base, batch, lora=lambda name:
                          lora_lib.kernel_delta(adapters, name, cfg))

    def train_step(self, state: TrainState, base: Params, batch: dict
                   ) -> tuple[TrainState, dict]:
        """One optimizer step of the adapters on a placed batch, in
        place; ``(state, {"loss", "tokens"})``, on the device."""
        loss, tokens, grads = accumulated_grads(
            lambda p, mb: self._lora_loss(p, base, mb), state.params, batch,
            self.accum_steps)
        if self.mesh is not None:
            self._sum_adapter_grads(grads)
        self.tx.update_(grads, state.opt_state, state.params)
        state.step += 1
        return state, {"loss": loss, "tokens": tokens}

    @torch.no_grad()
    def _sum_adapter_grads(self, grads: Params) -> None:
        """Each adapter's gradient summed over the data axes, then over
        tp where a block cuts its kernel there (the module docstring):
        one all-reduce of the flattened leaves for each set."""
        from ..parallel import collectives as coll
        from ..parallel.sharding import DATA_AXES, tp_cut
        keys = list(grads)
        cut = [k for k in keys if tp_cut(k.rsplit(".", 1)[0],
                                         self.tp_route) is not None]
        for axes, ks in ((DATA_AXES, keys), ("tp", cut)):
            if not ks or self.mesh.size(axes) == 1:
                continue
            flat = torch.cat([grads[k].reshape(-1) for k in ks])
            coll.all_reduce_(flat, self.mesh, axes)
            for k, part in zip(ks, flat.split([grads[k].numel()
                                               for k in ks])):
                grads[k] = part.view_as(grads[k])

    @torch.no_grad()
    def eval_step(self, adapters: Params, base: Params, batch: dict
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(loss * tokens, tokens)`` of base + adapters, with no full
        candidate materialised beyond the adapted kernels."""
        loss, tokens = self._lora_loss(adapters, base, batch)
        return loss * tokens, tokens

    def evaluate_adapters(self, adapters: Params, base: Params,
                          batches: Iterable[dict]) -> tuple[float, float]:
        """``(mean loss, perplexity)`` of base + adapters over an eval
        set, as :meth:`TrainEngine.evaluate`."""
        return self._evaluate(lambda b: self.eval_step(adapters, base, b),
                              batches)


class LoRAMinerLoop(MinerLoop):
    """The miner's loop whose artifact is the adapter tree. The full
    loop's cadences, finiteness screen, guard and checkpoints are
    reused; "train step", "delta" and "base reset" change meaning.
    ``base_params`` holds the frozen base, ``state.params`` the
    adapters. ``wire_v2`` is refused: adapters publish their own compact
    form (and ``delta_dtype``, a full-parameter knob, does nothing)."""

    def __init__(self, engine: LoRAEngine, transport, miner_id: str, **kw):
        if kw.get("wire_v2"):
            raise ValueError("wire_v2 is a full-param wire format; LoRA "
                             "adapters publish their own compact form")
        super().__init__(engine, transport, miner_id, **kw)
        self._seed = 0

    # -- base lifecycle -----------------------------------------------------
    def bootstrap(self, params=None, *, seed: int = 0) -> None:
        """Resume from the latest local checkpoint; else pull the
        published base; else start from ``params`` (a tree or a
        zero-argument callable, invoked only here), else a random base
        drawn with numpy from ``seed``. The adapters start from
        ``seed``'s key."""
        self._seed = seed
        if self._restore_checkpoint():
            if self.base_fetcher is not None:
                base = wire_out(self.engine,
                                self.engine.gather(self.base_params))
                if _coordinator():
                    self.base_fetcher.seed(base)
            return
        if self._multi():
            fetched = self._fetch_base_broadcast()
        elif self.transport.base_revision() is not None:
            fetched = self._bootstrap_fetch_base()
        else:
            fetched = None
        if fetched is not None:
            base, self._base_revision = fetched
            base = wire_in(self.engine, base)
        else:
            base = params() if callable(params) else params
            if base is None:
                base = init_params_numpy(self.engine.model.cfg, seed)
        self.base_params = self.engine.place_base(self._as_state(base))
        self.state = self.engine.init_state(self._seed)

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
        base, rev = fetched
        logger.info("lora miner %s: new base %s — resetting adapters and "
                    "optimizer", self.miner_id, rev and rev[:8])
        self.base_params = None        # one base on the card at a time
        self.base_params = self.engine.place_base(
            self._as_state(wire_in(self.engine, base)))
        self.state = self.engine.init_state(self._seed)
        self._base_revision = rev
        self._last_base_time = self.clock.now()
        self._reset_val_guard()
        self.report.base_pulls += 1

    # -- the guard, the artifact, the step ------------------------------------
    def _guard_eval(self) -> float:
        """The candidate (base + adapters) through the three-argument
        eval step: no full candidate is built."""
        return self.engine.evaluate_adapters(
            self.state.params, self.base_params, self.val_batches())[0]

    @torch.no_grad()
    def _push_snapshot(self):
        """``(adapter tree, finite)``: copies of the adapters (the next
        steps overwrite them in place) in the wire's per-block form (a
        scan layout's ``[L, in, r]`` factors unstacked), with a None at
        every other leaf of the base, and their 0-dim finite flag. No
        delta is subtracted and nothing is compressed."""
        adapters = {k: v.detach().clone()
                    for k, v in self.state.params.items()}
        return (lora_lib.wire_adapters(wire_out(self.engine, adapters),
                                       self._wire_template()),
                delta_lib.tree_finite(adapters))

    def _train_one(self, batch: dict) -> dict:
        self.state, m = self.engine.train_step(
            self.state, self.base_params, self.engine.place_batch(batch))
        return m


# ---------------------------------------------------------------------------
# The fetch side
# ---------------------------------------------------------------------------

def densify_adapter_bytes(data: bytes, base,
                          lora_cfg: lora_lib.LoRAConfig, *,
                          lora_template=None) -> dict | None:
    """The LoRA tail of ``engine/ingest.densify_delta_bytes``: ``data``
    (envelope stripped) validated against the adapter template (the one
    given, or one built from the host template ``base``), and the dense
    wire-layout host delta rebuilt from it; None when it is not an
    adapter tree. ``base`` may hold the adapted kernels alone: the
    payload's other leaves are then not read."""
    from .. import serialization as ser
    if lora_template is None:
        lora_template = adapter_template(base, lora_cfg)
    try:
        adapters = ser.validated_load(data, lora_template)
    except ser.PayloadError:
        return None
    return lora_lib.densify_adapters(base, adapters, lora_cfg)


def fetch_delta_any(transport, hotkey: str, base,
                    lora_cfg: Optional[lora_lib.LoRAConfig] = None, *,
                    lora_template=None, quant_template=None,
                    accept_quant: bool = True):
    """A miner's submission as a dense wire-layout host delta, whatever
    its wire form, or None (the caller scores 0): its bytes fetched once
    and read by ``engine/ingest.densify_delta_bytes``."""
    from .ingest import densify_delta_bytes
    data = transport.fetch_delta_bytes(hotkey)
    if data is None:
        return None
    return densify_delta_bytes(data, base, lora_cfg,
                               lora_template=lora_template,
                               quant_template=quant_template,
                               accept_quant=accept_quant)


def fetch_delta_any_broadcast(transport, hotkey: str, base_template,
                              lora_cfg: Optional[lora_lib.LoRAConfig] = None,
                              *, lora_template=None, quant_template=None,
                              accept_quant: bool = True):
    """The pod spelling of :func:`fetch_delta_any`: the coordinator reads
    the raw bytes, every rank receives them and densifies the same
    bytes (an adapter tree stays MB-sized on the wire between ranks).
    ``base_template`` is a host tree (shapes only are read)."""
    from .ingest import densify_delta_bytes
    from .train import broadcast_optional_bytes
    data = broadcast_optional_bytes(transport.fetch_delta_bytes(hotkey)
                                    if _coordinator() else None)
    if data is None:
        return None
    return densify_delta_bytes(data, base_template, lora_cfg,
                               lora_template=lora_template,
                               quant_template=quant_template,
                               accept_quant=accept_quant)
