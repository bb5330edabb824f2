"""GPT-2 in PyTorch — the port of the JAX package's ``models/gpt2.py``.

Same architecture and numerics contract: learned positions, pre-LN
blocks with a fused ``[E, 3E]`` QKV projection, tanh GELU, LayerNorm eps
1e-5, a vocabulary padded to a multiple of ``vocab_multiple``, and a
tied LM head whose products accumulate in f32. Parameters are stored in
``param_dtype`` (f32) and cast to the compute ``dtype`` (bf16 when
serving) at each use, as Flax's ``Dense(dtype=...)`` does.

Parameters keep the JAX package's names and layouts: the module's
``state_dict`` keys are the JAX param tree's paths joined with ``.``
(``h_0.c_attn.kernel``, ``ln_f.scale``, ``wte``, ...), dense kernels are
``[in, out]`` and ``wte`` is ``[padded_vocab, E]``. ``params_from_numpy``
/ ``params_to_numpy`` carry weights across, unchanged.

A ``GPT2`` is built on the ``meta`` device — a structure with no
storage — and :func:`bind` attaches a state to a fresh copy without
copying it (``load_state_dict(assign=True)``), which is how the serving
engine rebinds weights on a hot swap. Bound parameters never take
gradients (``requires_grad=False``), so serving records no graph. Training
runs the same forward through ``torch.func.functional_call`` with its own
leaf tensors (engine/train.py), the spelling of the JAX package's
``model.apply({"params": p}, ...)``; gradients reach those tensors.

One forward serves both. Training passes packed batches: ``segment_ids``
(attention stays inside a document; flash attention takes them as its
mask) and per-row ``position_ids [B, T]``; ``return_hidden`` stops before
the tied head. Serving passes the hooks: ``sow_kv`` returns each layer's
``(k, v)``, and ``kv_pages``/``page_tables``/``kv_lens`` switch attention
to paged decode (ops/paged_attention.py). Dropout and remat are
training's and are not ported (engine/train.py refuses them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from ..ops.attention import causal_attention
from ..ops.embed import embed_lookup
from ..ops.paged_attention import paged_attention

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pad_vocab(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    dropout: float = 0.0
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"   # storage dtype
    remat: bool = False
    attention_impl: str = "flash"  # "dense" | "flash" | "blockwise" | "ring"
    vocab_multiple: int = 128      # pad vocab to a multiple of this
    scan_blocks: bool = False      # the port always runs unrolled blocks
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


PRESETS: dict[str, GPT2Config] = {
    "gpt2-124m": GPT2Config(),
    "gpt2-355m": GPT2Config(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-774m": GPT2Config(n_embd=1280, n_layer=36, n_head=20),
    "gpt2-1.5b": GPT2Config(n_embd=1600, n_layer=48, n_head=25),
    "tiny": GPT2Config(vocab_size=512, n_positions=128, n_embd=64,
                       n_layer=2, n_head=4, vocab_multiple=128),
    "mini": GPT2Config(vocab_size=512, n_positions=128, n_embd=128,
                       n_layer=4, n_head=4, vocab_multiple=128),
}


def _param(shape, cfg: GPT2Config) -> nn.Parameter:
    # a placeholder on the meta device; bind() assigns the real tensor
    return nn.Parameter(torch.empty(shape, dtype=cfg.storage_dtype(),
                                    device="meta"), requires_grad=False)


class Dense(nn.Module):
    """Flax ``nn.Dense``: kernel ``[in, out]``; input, kernel and bias
    are cast to the compute dtype and the bias is added after the
    product is rounded to it."""

    def __init__(self, n_in: int, n_out: int, cfg: GPT2Config):
        super().__init__()
        self.kernel = _param((n_in, n_out), cfg)
        self.bias = _param((n_out,), cfg)
        self.dtype = cfg.compute_dtype()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm``: statistics in f32 (mean and E[x^2] - mean^2,
    clipped at 0), normalise, scale and shift in f32, cast to the
    compute dtype."""

    def __init__(self, n: int, cfg: GPT2Config):
        super().__init__()
        self.scale = _param((n,), cfg)
        self.bias = _param((n,), cfg)
        self.eps = cfg.layer_norm_epsilon
        self.dtype = cfg.compute_dtype()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.dtype)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        E = cfg.n_embd
        self.cfg = cfg
        self.ln_1 = LayerNorm(E, cfg)
        self.c_attn = Dense(E, 3 * E, cfg)
        self.c_proj = Dense(E, E, cfg)
        self.ln_2 = LayerNorm(E, cfg)
        self.c_fc = Dense(E, 4 * E, cfg)
        self.mlp_proj = Dense(4 * E, E, cfg)

    def forward(self, x: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                segment_ids: torch.Tensor | None = None, *,
                kv_pages: tuple | None = None,
                page_tables: torch.Tensor | None = None,
                kv_lens: torch.Tensor | None = None):
        """Returns ``(x, (k, v))``: the block output and this block's
        fresh keys/values ``[B, T, H, D]``. With ``kv_pages=(k_pages,
        v_pages)`` (this layer's pool slice) attention reads the pool
        through ``page_tables``; the fresh ``(k, v)`` reach the pool
        only through the caller, after the forward."""
        cfg = self.cfg
        B, T, E = x.shape
        qkv = self.c_attn(self.ln_1(x))
        q, k, v = qkv.split(E, dim=-1)
        q = q.reshape(B, T, cfg.n_head, cfg.head_dim)
        k = k.reshape(B, T, cfg.n_head, cfg.head_dim)
        v = v.reshape(B, T, cfg.n_head, cfg.head_dim)
        if kv_pages is not None:
            attn = paged_attention(q, kv_pages[0], kv_pages[1],
                                   page_tables, kv_lens, k, v)
        else:
            attn = causal_attention(q, k, v, attention_mask=attention_mask,
                                    segment_ids=segment_ids,
                                    impl=cfg.attention_impl)
        x = x + self.c_proj(attn.reshape(B, T, E))
        h = self.c_fc(self.ln_2(x))
        h = nn.functional.gelu(h, approximate="tanh")   # gelu_new
        return x + self.mlp_proj(h), (k, v)


class GPT2(nn.Module):
    """Decoder-only transformer; ``forward`` returns
    ``[B, T, padded_vocab]`` logits (and the per-layer ``(k, v)`` list
    when ``sow_kv``), or the final normed hidden states ``[B, T, E]``
    when ``return_hidden``."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.wte = _param((cfg.padded_vocab, cfg.n_embd), cfg)
        self.wpe = _param((cfg.n_positions, cfg.n_embd), cfg)
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg))
        self.ln_f = LayerNorm(cfg.n_embd, cfg)

    def blocks(self) -> list[Block]:
        return [getattr(self, f"h_{i}") for i in range(self.cfg.n_layer)]

    def forward(self, input_ids: torch.Tensor, *,
                attention_mask: torch.Tensor | None = None,
                segment_ids: torch.Tensor | None = None,
                position_ids: torch.Tensor | None = None,
                return_hidden: bool = False,
                sow_kv: bool = False,
                kv_pages: list | None = None,
                page_tables: torch.Tensor | None = None,
                kv_lens: torch.Tensor | None = None):
        """``position_ids`` is ``[T]`` or per row ``[B, T]`` (packing
        restarts positions at each document); it defaults to
        ``arange(T)``."""
        cfg = self.cfg
        T = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(T, device=input_ids.device)
        x = embed_lookup(self.wte, input_ids) + embed_lookup(self.wpe,
                                                             position_ids)
        x = x.to(cfg.compute_dtype())
        kvs = []
        for i, blk in enumerate(self.blocks()):
            x, kv = blk(x, attention_mask, segment_ids,
                        kv_pages=None if kv_pages is None else kv_pages[i],
                        page_tables=page_tables, kv_lens=kv_lens)
            kvs.append(kv)
        x = self.ln_f(x)
        if return_hidden:
            return x
        # tied head: compute-dtype products, exact in f32, summed in f32
        # (the JAX package's preferred_element_type=float32)
        wte = self.wte.to(cfg.compute_dtype()).float()
        logits = (x.float() @ wte.T).to(_TORCH_DTYPES[cfg.logits_dtype])
        return (logits, kvs) if sow_kv else logits


def make_model(preset_or_cfg) -> tuple[GPT2, GPT2Config]:
    """``(GPT2 structure on the meta device, config)``; weights come
    with :func:`bind`."""
    cfg = PRESETS[preset_or_cfg] if isinstance(preset_or_cfg, str) \
        else preset_or_cfg
    return GPT2(cfg), cfg


def bind(model_or_cfg, state: Mapping[str, torch.Tensor]) -> GPT2:
    """A fresh GPT2 whose parameters ARE ``state``'s tensors (no copy):
    same names and shapes required, the device is the state's."""
    cfg = model_or_cfg.cfg if isinstance(model_or_cfg, GPT2) \
        else model_or_cfg
    model = GPT2(cfg)
    model.load_state_dict(dict(state), strict=True, assign=True)
    return model


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist. There is
    no fallback to the CPU: the CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Weights: the JAX package's unrolled param tree <-> a state dict
# ---------------------------------------------------------------------------

def params_from_numpy(tree: Mapping[str, Any], *, device="cuda"
                      ) -> dict[str, torch.Tensor]:
    """The JAX package's unrolled GPT-2 param tree (nested dicts of
    arrays: ``h_{i}/c_attn/kernel``, ``ln_1/scale``, ``wte``, ...) as a
    state dict keyed by the ``.``-joined paths, on ``device`` (``"cuda"``
    unless the caller asks for the CPU). Values, dtypes and layouts are
    unchanged."""
    if "h" in tree:
        raise ValueError("scan-layout param tree (h/block); unstack it to "
                         "the unrolled h_{i} layout first")
    device = resolve_device(device)
    state: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            path = f"{prefix}{key}"
            if isinstance(val, Mapping):
                walk(val, path + ".")
            else:
                # a private, writable, C-ordered copy (arrays handed over
                # from JAX are read-only views)
                state[path] = torch.from_numpy(np.array(val, order="C")
                                               ).to(device)

    walk(tree, "")
    return state


def params_to_numpy(state: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_numpy`: the nested numpy tree."""
    tree: dict = {}
    for path, t in state.items():
        *parents, leaf = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy()
    return tree


def init_params_numpy(cfg: GPT2Config, seed: int) -> dict:
    """Random weights in the JAX package's unrolled tree and init
    distributions (normal 0.02 for dense kernels and ``wte``, 0.01 for
    ``wpe``, ones/zeros for LayerNorm, zero biases), drawn with numpy
    from ``seed``. The draws differ from ``jax.random``'s; the
    distributions and layouts do not."""
    rng = np.random.default_rng(seed)
    E = cfg.n_embd
    dt = np.dtype(cfg.param_dtype)

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32) * std
                ).astype(dt)

    def ln():
        return {"scale": np.ones((E,), dt), "bias": np.zeros((E,), dt)}

    def dense(n_in, n_out):
        return {"kernel": normal((n_in, n_out), 0.02),
                "bias": np.zeros((n_out,), dt)}

    tree = {"wte": normal((cfg.padded_vocab, E), 0.02),
            "wpe": normal((cfg.n_positions, E), 0.01)}
    for i in range(cfg.n_layer):
        tree[f"h_{i}"] = {"ln_1": ln(), "c_attn": dense(E, 3 * E),
                          "c_proj": dense(E, E), "ln_2": ln(),
                          "c_fc": dense(E, 4 * E),
                          "mlp_proj": dense(4 * E, E)}
    tree["ln_f"] = ln()
    return tree
