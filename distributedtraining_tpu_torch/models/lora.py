"""LoRA adapters as delta subtrees — the port of the JAX package's
``models/lora.py``.

A LoRA miner trains low-rank factors ``a [in, r]`` and ``b [r, out]`` for
each targeted kernel of a frozen base and ships the adapter tree alone;
validators and averagers rebuild the dense delta as ``(a @ b) * (alpha /
rank)`` per kernel, and the delta algebra (``delta.py``) and the merge
strategies apply unchanged.

The port keeps the adapters as a flat dict, as it keeps parameters: the
factors of the kernel ``h_0.c_attn.kernel`` are ``h_0.c_attn.kernel.a``
and ``h_0.c_attn.kernel.b`` (so AdamW, the gradient accumulation and the
checkpoints take them as they take a state dict). On the wire the tree
is JAX's: nested dicts in which an adapted kernel is ``{"a", "b"}`` and
every other leaf of the base is ``None`` (msgpack nil), so the bytes
equal the JAX package's ``to_msgpack`` of the same adapters
(:func:`adapters_to_numpy` builds that tree, :func:`adapters_from_numpy`
reads one back).

A target is a 2-D kernel ``[in, out]`` of the unrolled layout or a 3-D
kernel ``[L, in, out]`` of the scan layout (``--scan-blocks``), whose
factors ``[L, in, r]`` / ``[L, r, out]`` multiply layer by layer; the
wire carries the unrolled per-block form either way
(``engine/train.wire_out``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

Params = dict[str, torch.Tensor]

DEFAULT_TARGETS = ("c_attn", "wq", "wk", "wv", "wo", "c_proj")

# the two factors of an adapted kernel, as the wire names them
FACTORS = ("a", "b")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    # a kernel is adapted iff one of its path components contains one of
    # these names
    target_patterns: tuple = DEFAULT_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _components(path) -> tuple[str, ...]:
    if isinstance(path, str):
        return tuple(path.split("."))
    return tuple(str(p) for p in path)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))


def is_target(path, leaf, cfg: LoRAConfig) -> bool:
    """True when the leaf at ``path`` (a ``.``-joined state-dict key or a
    tuple of components) is adapted: its last component is ``kernel``,
    it is 2-D (unrolled ``[in, out]``) or 3-D (the scan layout's ``[L,
    in, out]``), and a component contains one of ``cfg``'s patterns."""
    comps = _components(path)
    if comps and comps[-1] != "kernel":
        return False
    if len(_shape(leaf)) not in (2, 3):
        return False
    return any(pat in comp for comp in comps for pat in cfg.target_patterns)


def _walk(tree):
    """``(path, leaf)`` of a flat state dict or a nested tree, keys
    sorted per level: the order of JAX's ``tree_flatten`` of the nested
    tree."""
    from ..delta import _walk_state_dict, nest_tree
    if not any(isinstance(v, Mapping) for v in tree.values()):
        tree = nest_tree(tree)
    return _walk_state_dict(tree)


def targets(base: Mapping[str, Any], cfg: LoRAConfig
            ) -> dict[str, tuple[int, int]]:
    """``{kernel key: shape}`` of every adapted kernel of ``base`` (a
    state dict or a nested tree, of tensors, arrays or anything with a
    shape), in JAX's flatten order."""
    return {".".join(p): _shape(leaf) for p, leaf in _walk(base)
            if is_target(p, leaf, cfg)}


def init_lora(key, base: Mapping[str, Any], cfg: LoRAConfig, *,
              device="cpu") -> Params:
    """The adapters of ``base`` (shapes only are read): for each adapted
    ``[..., in, out]`` kernel ``a = normal * 0.02`` (``[..., in, r]``)
    and ``b = 0`` (``[..., r, out]``), so the initial delta is exactly
    zero. ``key`` is a ``utils.prng`` key (or an
    int seed, ``jax.random.PRNGKey(seed)``); as in JAX, the base's
    flattened leaves take one key each from ``split(key, n_leaves)``,
    and the normals are ``jax.random.normal``'s (within a few ulps)."""
    from ..utils import prng
    if not isinstance(key, torch.Tensor):
        key = prng.prng_key(int(key))
    leaves = list(_walk(base))
    keys = prng.split(key.cpu(), len(leaves))
    out: Params = {}
    for i, (path, leaf) in enumerate(leaves):
        if not is_target(path, leaf, cfg):
            continue
        *lead, fan_in, fan_out = _shape(leaf)
        name = ".".join(path)
        a = prng.normal(keys[i], int(np.prod(lead, dtype=np.int64))
                        * fan_in * cfg.rank).reshape(
            *lead, fan_in, cfg.rank) * 0.02
        out[name + ".a"] = a.to(device)
        out[name + ".b"] = torch.zeros((*lead, cfg.rank, fan_out),
                                       dtype=torch.float32, device=device)
    return out


def kernel_delta(adapters: Mapping[str, torch.Tensor], name: str,
                 cfg: LoRAConfig) -> torch.Tensor | None:
    """``(a @ b) * scaling`` of the kernel ``name``, or None where it is
    not adapted."""
    a = adapters.get(name + ".a")
    if a is None:
        return None
    return (a @ adapters[name + ".b"]) * cfg.scaling


def apply_lora(base: Mapping[str, torch.Tensor],
               adapters: Mapping[str, torch.Tensor],
               cfg: LoRAConfig) -> Params:
    """Effective params: ``base + (a @ b) * scaling`` on adapted kernels,
    cast to the base's dtype; the base's own tensors elsewhere.
    Differentiable in ``adapters``: the LoRA train step's forward."""
    out = dict(base)
    for name in adapted_kernels(adapters):
        b = base[name]
        out[name] = b + kernel_delta(adapters, name, cfg).to(b.dtype)
    return out


def lora_to_full_delta(base: Mapping[str, torch.Tensor],
                       adapters: Mapping[str, torch.Tensor],
                       cfg: LoRAConfig) -> Params:
    """The dense delta in the base's structure: ``(a @ b) * scaling`` on
    adapted kernels, zeros elsewhere (what a validator applies when it
    scores a LoRA submission beside full-parameter ones)."""
    out = {}
    for k, b in base.items():
        d = kernel_delta(adapters, k, cfg)
        out[k] = torch.zeros_like(b) if d is None else d.to(b.dtype)
    return out


def adapted_kernels(adapters: Mapping[str, Any]) -> list[str]:
    """The kernel keys the adapters adapt, in their order."""
    return [k[:-2] for k in adapters if k.endswith(".a")]


def adapted_pairs(adapters: Mapping[str, torch.Tensor]
                  ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``(a, b)`` of every adapted kernel."""
    return [(adapters[k + ".a"], adapters[k + ".b"])
            for k in adapted_kernels(adapters)]


def wire_adapters(adapters: Mapping[str, Any],
                  base: Mapping[str, Any]) -> dict:
    """The flat adapters with a None entry at every other leaf of
    ``base`` (a state dict or a nested tree): what
    ``delta.nest_tree`` turns into JAX's adapter tree."""
    adapted = set(adapted_kernels(adapters))
    out: dict = {}
    for path, _ in _walk(base):
        name = ".".join(path)
        if name in adapted:
            for f in FACTORS:
                out[f"{name}.{f}"] = adapters[f"{name}.{f}"]
        else:
            out[name] = None
    return out


def adapters_to_numpy(adapters: Mapping[str, torch.Tensor],
                      base: Mapping[str, Any]) -> dict:
    """JAX's adapter tree in its state-dict form (``flax.serialization.
    to_state_dict`` of the ``LoRAPair`` tree): nested dicts, ``{"a",
    "b"}`` numpy arrays at adapted kernels and None at every other leaf
    of ``base``."""
    from ..delta import nest_tree

    def host(v):
        return None if v is None else v.detach().cpu().numpy()

    return nest_tree({k: host(v)
                      for k, v in wire_adapters(adapters, base).items()})


def adapters_from_numpy(tree: Mapping[str, Any], *, device="cuda"
                        ) -> Params:
    """The port's flat adapters from JAX's adapter tree (nested dicts
    with ``{"a", "b"}`` pairs and None leaves, as
    :func:`adapters_to_numpy` gives it or the wire carries it), on
    ``device`` (``"cuda"`` unless the caller asks for the CPU)."""
    from .gpt2 import resolve_device
    dev = resolve_device(device)
    out: Params = {}
    for path, leaf in _walk(tree):
        if leaf is None:
            continue
        out[".".join(path)] = torch.as_tensor(
            np.array(leaf, dtype=np.float32)).to(dev)
    return out


def adapter_template(base_template: Mapping[str, Any], cfg: LoRAConfig
                     ) -> dict:
    """The wire template of adapter payloads for the nested host
    template ``base_template`` (shapes only are read): zeros ``{"a":
    [..., in, r], "b": [..., r, out]}`` at adapted kernels (views of one
    scalar: nothing is allocated), None elsewhere."""
    from ..delta import nest_tree
    zero = np.zeros((), np.float32)
    flat: dict = {}
    for path, leaf in _walk(base_template):
        name = ".".join(path)
        if is_target(path, leaf, cfg):
            *lead, fan_in, fan_out = _shape(leaf)
            flat[name + ".a"] = np.broadcast_to(zero, (*lead, fan_in,
                                                       cfg.rank))
            flat[name + ".b"] = np.broadcast_to(zero, (*lead, cfg.rank,
                                                       fan_out))
        else:
            flat[name] = None
    return nest_tree(flat)


def densify_adapters(base_template: Mapping[str, Any],
                     adapters: Mapping[str, Any], cfg: LoRAConfig) -> dict:
    """The dense wire-layout host delta (numpy, nested like
    ``base_template``) of a wire adapter tree: ``(a @ b) * scaling`` in
    f32 at adapted kernels, cast to the template's dtype, zeros
    elsewhere (:func:`lora_to_full_delta` on the host)."""
    from ..delta import _dtype_name, nest_tree
    pairs = {".".join(p[:-1]): None for p, leaf in _walk(adapters)
             if leaf is not None}
    flat = {}
    for path, leaf in _walk(base_template):
        name = ".".join(path)
        dtype = np.dtype(_dtype_name(leaf))
        if name in pairs:
            node = adapters
            for p in path:
                node = node[p]
            a = np.asarray(node["a"], np.float32)
            b = np.asarray(node["b"], np.float32)
            flat[name] = ((a @ b) * np.float32(cfg.scaling)).astype(dtype)
        else:
            flat[name] = np.zeros(_shape(leaf), dtype)
    return nest_tree(flat)
