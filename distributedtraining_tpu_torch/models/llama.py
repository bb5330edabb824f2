"""The Llama family in PyTorch — the port of the JAX package's
``models/llama.py`` (Llama-2-7B, Llama-3-8B and a tiny preset).

Same architecture and numerics contract: RMSNorm pre-norm (f32 mean of
squares, rsqrt with eps, times the scale), rotary position embeddings
(f32 angles, the head's halves rotated, cast back), a SwiGLU MLP
``w_down(silu(w_gate h) * w_up h)``, grouped-query attention, no biases,
a vocabulary padded to a multiple of ``vocab_multiple`` and an untied
``lm_head`` whose products are made in the compute dtype and summed in
f32. Parameters are stored in ``param_dtype`` (f32) and cast to the
compute ``dtype`` at each use, as Flax's ``Dense(dtype=...)`` does.

Parameters keep the JAX package's names and layouts: the ``state_dict``
keys are the JAX param tree's paths joined with ``.``
(``layer_0.wq.kernel`` ``[in, out]``, ``layer_0.attn_norm.scale``,
``final_norm.scale``, ``wte`` and ``lm_head`` ``[padded_vocab, E]``).
``params_from_numpy`` / ``params_to_numpy`` are the GPT-2 module's
(family-neutral); :func:`init_params_numpy` draws this family's tree.

One forward serves training and serving, as ``models/gpt2.py``'s does.
Training and full prefills broadcast the kv heads to the query heads
(``repeat_interleave`` on the head axis, JAX's ``jnp.repeat``) before
``ops.attention.causal_attention``; the paged decode and window route
(``kv_pages``/``page_tables``/``kv_lens``, ops/paged_attention.py) is
GQA-native and reads the Hkv-head pool as it is. ``sow_kv`` returns each
layer's post-RoPE, pre-broadcast ``(k, v)`` with Hkv heads, so the KV
pool is ``n_head / n_kv_head`` times smaller than the activations. With
``cfg.remat`` the training forward recomputes each block in the backward
(``models.gpt2.remat_block``); the serving forward never does. With
``cfg.scan_blocks`` the blocks are one ``models.gpt2.BlockScan`` under
JAX's ``layers.block.<leaf>`` names (``[L, ...]`` leaves), as GPT-2's
are under ``h.block``; :func:`stack_blocks` / :func:`unstack_blocks`
convert (``prefix="layer_"``, ``scan_key="layers"``).

On a mesh (engine/train.py's ``_mesh_hidden``) a block takes GPT-2's
keywords: ``tp`` splits the MLP's columns and, with ``tp_heads``, the
query and kv heads (``parallel.sharding.block_param``), each half
entering through ``collectives.copy_to`` and leaving through the
all-reduce of a row-parallel ``wo`` or ``w_down``; ``sp`` attends over
the sequence axis (the ring or the gathered route, on ``Hq`` heads after
the kv broadcast, as JAX's ``jnp.repeat`` hands them over), RoPE reading
the rank's global positions from ``position_ids``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..ops.attention import causal_attention
from ..ops.embed import embed_lookup
from ..ops.paged_attention import paged_attention
from . import gpt2 as _gpt2
from .gpt2 import (_TORCH_DTYPES, BlockScan, _param, _tp_enter, pad_vocab,
                   refuse_scan_generation, remat_block)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 4096
    n_embd: int = 4096
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 32
    intermediate_size: int = 11008
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"   # storage dtype
    remat: bool = True
    attention_impl: str = "flash"  # "dense" | "flash" | "blockwise" | "ring"
    vocab_multiple: int = 128
    # one block stored [L, ...] under layers/block (BlockScan)
    scan_blocks: bool = False
    logits_dtype: str = "float32"

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size, self.vocab_multiple)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def compute_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    def storage_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.param_dtype]


PRESETS: dict[str, LlamaConfig] = {
    "llama2-7b": LlamaConfig(),
    "llama3-8b": LlamaConfig(vocab_size=128256, max_seq_len=8192,
                             n_kv_head=8, intermediate_size=14336,
                             rope_theta=500000.0),
    "tiny-llama": LlamaConfig(vocab_size=512, max_seq_len=128, n_embd=64,
                              n_layer=2, n_head=4, n_kv_head=2,
                              intermediate_size=128, remat=False),
}


def rotary_embedding(x: torch.Tensor, position_ids: torch.Tensor,
                     theta: float) -> torch.Tensor:
    """RoPE on ``x [B, T, H, D]`` at ``position_ids [B, T]``: f32
    angles, the first and second halves of each head rotated as a pair,
    the result cast back to ``x``'s dtype. The frequencies
    ``1 / theta^(2i / D)`` are rounded once to f32 from a float64
    power, the value XLA's compiled program gives (an f32 power and then
    an f32 division miss it by an ulp at a third of the entries, which
    at position 8191 moves an angle by ~1e-3)."""
    D = x.shape[-1]
    expo = torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D
    inv_freq = (1.0 / theta ** expo.double()).float()
    angles = position_ids[..., None].float() * inv_freq      # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2) + eps) * scale`` in f32, cast back to the
    input's dtype."""

    def __init__(self, n: int, cfg: LlamaConfig):
        super().__init__()
        self.scale = _param((n,), cfg)
        self.eps = cfg.rms_norm_eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True)
                                + self.eps)
        return (norm * self.scale.float()).to(x.dtype)


class Dense(nn.Module):
    """Flax ``nn.Dense(use_bias=False)``: kernel ``[in, out]``; input and
    kernel cast to the compute dtype before the product."""

    def __init__(self, n_in: int, n_out: int, cfg: LlamaConfig):
        super().__init__()
        self.kernel = _param((n_in, n_out), cfg)
        self.dtype = cfg.compute_dtype()

    def forward(self, x: torch.Tensor, tp=None) -> torch.Tensor:
        """With ``tp`` (a ``parallel.Mesh``), a row-parallel product: each
        tp rank's product is a partial sum, all-reduced over tp."""
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if tp is not None:
            from ..parallel.collectives import all_reduce
            y = all_reduce(y, tp, "tp")
        return y


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        E, D = cfg.n_embd, cfg.head_dim
        self.cfg = cfg
        self.attn_norm = RMSNorm(E, cfg)
        self.wq = Dense(E, cfg.n_head * D, cfg)
        self.wk = Dense(E, cfg.n_kv_head * D, cfg)
        self.wv = Dense(E, cfg.n_kv_head * D, cfg)
        self.wo = Dense(cfg.n_head * D, E, cfg)
        self.mlp_norm = RMSNorm(E, cfg)
        self.w_gate = Dense(E, cfg.intermediate_size, cfg)
        self.w_up = Dense(E, cfg.intermediate_size, cfg)
        self.w_down = Dense(cfg.intermediate_size, E, cfg)

    def forward(self, x: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                segment_ids: torch.Tensor | None = None,
                position_ids: torch.Tensor | None = None, *,
                kv_pages: tuple | None = None,
                page_tables: torch.Tensor | None = None,
                kv_lens: torch.Tensor | None = None,
                tp=None, tp_heads: bool = False, sp=None):
        """Returns ``(x, (k, v))``: the block output and this block's
        fresh post-RoPE keys/values ``[B, T, Hkv, D]``. ``position_ids``
        is ``[B, T]``. With ``kv_pages=(k_pages, v_pages)`` (this layer's
        pool slice) attention reads the pool through ``page_tables``;
        the fresh ``(k, v)`` reach the pool only through the caller.

        ``tp``, ``tp_heads`` and ``sp`` are ``models.gpt2.Block``'s: with
        ``tp`` the parameters are this rank's tp slices (the MLP's
        columns, and with ``tp_heads`` ``Hq/tp`` query heads, ``Hkv/tp``
        kv heads and their rows of ``wo``), and ``(k, v)`` are then this
        rank's kv heads; with ``sp`` ``x`` and ``position_ids`` hold this
        rank's positions and the masks the whole row's."""
        cfg = self.cfg
        B, T, _ = x.shape
        D = cfg.head_dim
        attn_tp = tp if tp_heads else None
        h = _tp_enter(self.attn_norm(x), attn_tp)
        q = rotary_embedding(self.wq(h).reshape(B, T, -1, D), position_ids,
                             cfg.rope_theta)
        k = rotary_embedding(self.wk(h).reshape(B, T, -1, D), position_ids,
                             cfg.rope_theta)
        v = self.wv(h).reshape(B, T, -1, D)
        if kv_pages is not None:
            attn = paged_attention(q, kv_pages[0], kv_pages[1], page_tables,
                                   kv_lens, k, v)
        else:
            rep = cfg.n_head // cfg.n_kv_head
            kf = k.repeat_interleave(rep, dim=2) if rep > 1 else k
            vf = v.repeat_interleave(rep, dim=2) if rep > 1 else v
            attn = causal_attention(q, kf, vf, attention_mask=attention_mask,
                                    segment_ids=segment_ids,
                                    impl=cfg.attention_impl, sp=sp)
        x = x + self.wo(attn.reshape(B, T, -1), attn_tp)
        h = _tp_enter(self.mlp_norm(x), tp)
        gated = nn.functional.silu(self.w_gate(h)) * self.w_up(h)
        return x + self.w_down(gated, tp), (k, v)


class Llama(nn.Module):
    """Decoder-only Llama; ``forward`` returns ``[B, T, padded_vocab]``
    logits (and the per-layer ``(k, v)`` list when ``sow_kv``), or the
    final normed hidden states ``[B, T, E]`` when ``return_hidden``."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = _param((cfg.padded_vocab, cfg.n_embd), cfg)
        if cfg.scan_blocks:
            self.layers = BlockScan(LlamaBlock(cfg), cfg.n_layer)
        else:
            for i in range(cfg.n_layer):
                self.add_module(f"layer_{i}", LlamaBlock(cfg))
        self.final_norm = RMSNorm(cfg.n_embd, cfg)
        self.lm_head = _param((cfg.padded_vocab, cfg.n_embd), cfg)

    def blocks(self) -> list[LlamaBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_layer)]

    def forward(self, input_ids: torch.Tensor, *,
                attention_mask: torch.Tensor | None = None,
                segment_ids: torch.Tensor | None = None,
                position_ids: torch.Tensor | None = None,
                return_hidden: bool = False,
                sow_kv: bool = False,
                kv_pages: list | None = None,
                page_tables: torch.Tensor | None = None,
                kv_lens: torch.Tensor | None = None):
        """``position_ids`` is ``[T]`` or per row ``[B, T]``; it defaults
        to ``arange(T)``."""
        cfg = self.cfg
        if sow_kv or kv_pages is not None:
            refuse_scan_generation(cfg)
        B, T = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(T, device=input_ids.device)
        position_ids = position_ids.expand(B, T)
        x = embed_lookup(self.wte, input_ids).to(cfg.compute_dtype())
        remat = (cfg.remat and torch.is_grad_enabled() and not sow_kv
                 and kv_pages is None)
        if cfg.scan_blocks:
            x = self.final_norm(self.layers(x, attention_mask, segment_ids,
                                            position_ids, remat=remat))
            return x if return_hidden else head_logits(x, self.lm_head, cfg)
        kvs = []
        for i, blk in enumerate(self.blocks()):
            if remat:
                x, kv = remat_block(blk, dict(blk.named_parameters()), x,
                                    attention_mask, segment_ids,
                                    position_ids)
            else:
                x, kv = blk(x, attention_mask, segment_ids, position_ids,
                            kv_pages=None if kv_pages is None
                            else kv_pages[i],
                            page_tables=page_tables, kv_lens=kv_lens)
            kvs.append(kv)
        x = self.final_norm(x)
        if return_hidden:
            return x
        logits = head_logits(x, self.lm_head, cfg)
        return (logits, kvs) if sow_kv else logits


def head_logits(x: torch.Tensor, lm_head: torch.Tensor, cfg: LlamaConfig
                ) -> torch.Tensor:
    """The untied head: compute-dtype products, exact in f32, summed in
    f32 (the JAX package's preferred_element_type=float32)."""
    w = lm_head.to(cfg.compute_dtype()).float()
    return (x.float() @ w.T).to(_TORCH_DTYPES[cfg.logits_dtype])


def make_model(preset_or_cfg) -> tuple[Llama, LlamaConfig]:
    """``(Llama structure on the meta device, config)``; weights come
    with :func:`bind`."""
    cfg = PRESETS[preset_or_cfg] if isinstance(preset_or_cfg, str) \
        else preset_or_cfg
    return Llama(cfg), cfg


def draft_compat(cfg: LlamaConfig, target_cfg) -> str | None:
    """Why a Llama with this config cannot DRAFT for a target with
    ``target_cfg`` (None = compatible; engine/speculative.py): the real
    vocabularies must be equal (the padded one may differ)."""
    tv = getattr(target_cfg, "vocab_size", None)
    if cfg.vocab_size != tv:
        return (f"draft vocab_size {cfg.vocab_size} != target "
                f"vocab_size {tv}: proposal ids would not name the "
                "same tokens")
    return None


def bind(model_or_cfg, state: Mapping[str, torch.Tensor]) -> Llama:
    """A fresh Llama whose parameters ARE ``state``'s tensors (no copy):
    same names and shapes required, the device is the state's."""
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    model = Llama(cfg)
    model.load_state_dict(dict(state), strict=True, assign=True)
    return model


def init_params_numpy(cfg: LlamaConfig, seed: int) -> dict:
    """Random weights in the JAX package's tree and init distributions
    (normal 0.02 for dense kernels, ``wte`` and ``lm_head``, ones for
    the norm scales), drawn with numpy from ``seed``; stacked when
    ``cfg.scan_blocks``. The draws differ from ``jax.random``'s; the
    distributions and layouts do not."""
    rng = np.random.default_rng(seed)
    E, D, F = cfg.n_embd, cfg.head_dim, cfg.intermediate_size
    dt = np.dtype(cfg.param_dtype)

    def normal(shape):
        return (rng.standard_normal(shape, dtype=np.float32) * 0.02
                ).astype(dt)

    def norm():
        return {"scale": np.ones((E,), dt)}

    tree = {"wte": normal((cfg.padded_vocab, E))}
    for i in range(cfg.n_layer):
        tree[f"layer_{i}"] = {
            "attn_norm": norm(),
            "wq": {"kernel": normal((E, cfg.n_head * D))},
            "wk": {"kernel": normal((E, cfg.n_kv_head * D))},
            "wv": {"kernel": normal((E, cfg.n_kv_head * D))},
            "wo": {"kernel": normal((cfg.n_head * D, E))},
            "mlp_norm": norm(),
            "w_gate": {"kernel": normal((E, F))},
            "w_up": {"kernel": normal((E, F))},
            "w_down": {"kernel": normal((F, E))}}
    tree["final_norm"] = norm()
    tree["lm_head"] = normal((cfg.padded_vocab, E))
    return stack_blocks(tree, cfg.n_layer) if cfg.scan_blocks else tree


def stack_blocks(params: Mapping, n_layer: int) -> dict:
    """Unrolled (``layer_0..``) -> scan layout (``layers/block``, leading
    ``[L]`` axis): ``models.gpt2.stack_blocks`` with this family's
    names."""
    return _gpt2.stack_blocks(params, n_layer, prefix="layer_",
                              scan_key="layers")


def unstack_blocks(params: Mapping, n_layer: int) -> dict:
    """Scan layout -> unrolled layout (inverse of :func:`stack_blocks`)."""
    return _gpt2.unstack_blocks(params, n_layer, prefix="layer_",
                                scan_key="layers")
