"""Models: GPT-2 and Llama with the JAX package's param names and layouts.

The family of a preset name, a config or a model is picked here, in one
place (the JAX package picks it at each of its roles' builds, and its
speculative engine by the drafter's module): every caller that builds,
binds or draws weights for "the model" goes through :func:`family` or
the dispatching functions below.
"""

from __future__ import annotations

from types import ModuleType
from typing import Mapping

from . import gpt2, llama, lora
from .gpt2 import params_from_numpy, params_to_numpy, resolve_device

__all__ = ["family", "make_model", "bind", "init_params_numpy",
           "draft_compat", "params_from_numpy", "params_to_numpy",
           "resolve_device", "stack_blocks", "unstack_blocks", "gpt2",
           "llama", "lora"]


def family(x) -> ModuleType:
    """The family module (``models.gpt2`` or ``models.llama``) of a preset
    name, a config, or a model (anything with a ``cfg``). An unknown
    preset name raises KeyError naming every preset."""
    if isinstance(x, str):
        for fam in (gpt2, llama):
            if x in fam.PRESETS:
                return fam
        raise KeyError(f"unknown model preset {x!r}; the presets are "
                       f"{sorted(gpt2.PRESETS) + sorted(llama.PRESETS)}")
    cfg = getattr(x, "cfg", x)
    return llama if isinstance(cfg, llama.LlamaConfig) else gpt2


def make_model(preset_or_cfg):
    """``(structure on the meta device, config)`` of either family."""
    return family(preset_or_cfg).make_model(preset_or_cfg)


def bind(model_or_cfg, state: Mapping):
    """A fresh model of ``model_or_cfg``'s family bound to ``state``'s
    tensors without a copy."""
    return family(model_or_cfg).bind(model_or_cfg, state)


def init_params_numpy(cfg, seed: int) -> dict:
    """Random weights of ``cfg``'s family as the JAX unrolled tree."""
    return family(cfg).init_params_numpy(cfg, seed)


def draft_compat(draft_cfg, target_cfg) -> str | None:
    """Why a drafter with ``draft_cfg`` cannot draft for a target with
    ``target_cfg`` (None = compatible): the drafter family's rule."""
    return family(draft_cfg).draft_compat(draft_cfg, target_cfg)


def stack_blocks(model_or_cfg, params: Mapping) -> dict:
    """``params`` (a nested tree or a flat state dict) from the unrolled
    block layout to the scan layout of ``model_or_cfg``'s family."""
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    return family(cfg).stack_blocks(params, cfg.n_layer)


def unstack_blocks(model_or_cfg, params: Mapping) -> dict:
    """The inverse of :func:`stack_blocks`."""
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    return family(cfg).unstack_blocks(params, cfg.n_layer)
