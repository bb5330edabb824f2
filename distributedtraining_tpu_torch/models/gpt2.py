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
to paged decode (ops/paged_attention.py). With ``cfg.remat`` the
training forward recomputes each block in the backward
(``torch.utils.checkpoint``, JAX's ``nn.remat(Block)``); the serving
forward never does (JAX ``:281``). Dropout is training's and is not
ported (engine/train.py refuses it; every preset has 0.0).

With ``cfg.scan_blocks`` (``--scan-blocks``, JAX's ``nn.scan`` over
``_BlockScan``) the blocks are one :class:`BlockScan`: each block
parameter is stored once for every layer, ``[L, ...]``, under JAX's name
``h.block.<leaf>`` (``h.block.c_attn.kernel`` is ``[L, E, 3E]``), and
the forward runs block ``i`` on the slices ``[i]`` (views of the stacked
tensors: the same products on the same values), under remat when
``cfg.remat`` is set. The layouts convert with :func:`stack_blocks` /
:func:`unstack_blocks`; artifacts travel unrolled whatever a role's
layout (``engine/train.wire_out``), and generation refuses the stacked
layout, as JAX's does (the serving engines rebuild unrolled).
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
    # one block stored [L, ...] under h/block (BlockScan); same math
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

    def forward(self, x: torch.Tensor, tp=None) -> torch.Tensor:
        """With ``tp`` (a ``parallel.Mesh``), a row-parallel product: each
        tp rank's product is a partial sum, all-reduced over tp before
        the bias is added once."""
        dt = self.dtype
        y = x.to(dt) @ self.kernel.to(dt)
        if tp is not None:
            from ..parallel.collectives import all_reduce
            y = all_reduce(y, tp, "tp")
        return y + self.bias.to(dt)


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
                kv_lens: torch.Tensor | None = None,
                tp=None, tp_heads: bool = False, sp=None):
        """Returns ``(x, (k, v))``: the block output and this block's
        fresh keys/values ``[B, T, H, D]``. With ``kv_pages=(k_pages,
        v_pages)`` (this layer's pool slice) attention reads the pool
        through ``page_tables``; the fresh ``(k, v)`` reach the pool
        only through the caller, after the forward.

        With ``tp`` (a ``parallel.Mesh`` whose tp axis is > 1) the
        parameters are this rank's tp slices, Megatron style
        (``parallel.sharding.block_param``): the MLP's ``4E/tp`` columns
        always, and with ``tp_heads`` the q, k and v of ``H/tp`` heads
        and their rows of ``c_proj`` (else the attention runs every head
        on whole parameters). A split half enters through
        ``collectives.copy_to`` (f: backward sums the cotangent over tp)
        and leaves through the all-reduce of a row-parallel product (g);
        ``(k, v)`` are then this rank's heads.

        With ``sp`` (a ``parallel.Mesh`` whose sp axis is > 1) ``x`` holds
        this rank's positions of each row and the masks the whole row's:
        ``ops.attention.causal_attention`` takes the ring or the gathered
        route over sp, which composes with the tp head split."""
        B, T, _ = x.shape
        D = self.cfg.head_dim
        attn_tp = tp if tp_heads else None
        qkv = self.c_attn(_tp_enter(self.ln_1(x), attn_tp))
        q, k, v = (t.reshape(B, T, -1, D)
                   for t in qkv.split(qkv.shape[-1] // 3, dim=-1))
        if kv_pages is not None:
            attn = paged_attention(q, kv_pages[0], kv_pages[1],
                                   page_tables, kv_lens, k, v)
        else:
            attn = causal_attention(q, k, v, attention_mask=attention_mask,
                                    segment_ids=segment_ids,
                                    impl=self.cfg.attention_impl, sp=sp)
        x = x + self.c_proj(attn.reshape(B, T, -1), attn_tp)
        h = self.c_fc(_tp_enter(self.ln_2(x), tp))
        h = nn.functional.gelu(h, approximate="tanh")   # gelu_new
        return x + self.mlp_proj(h, tp), (k, v)


class BlockScan(nn.Module):
    """JAX's ``nn.scan`` of a block over the layers: ``block``'s
    parameters each stored once as ``[n_layer, ...]`` (``<name>.block.
    <leaf>``), block ``i`` run on the slices ``[i]``."""

    def __init__(self, block: nn.Module, n_layer: int):
        super().__init__()
        for mod in block.modules():
            for name, p in list(mod._parameters.items()):
                mod._parameters[name] = nn.Parameter(
                    torch.empty((n_layer, *p.shape), dtype=p.dtype,
                                device="meta"), requires_grad=False)
        self.block = block
        self.n_layer = n_layer

    def layer_params(self) -> list[dict[str, torch.Tensor]]:
        """Each layer's parameters: the stacked tensors unbound along
        their first axis (views; autograd stacks their gradients back
        into one ``[L, ...]`` gradient, each slice's in its place)."""
        named = dict(self.block.named_parameters())
        per = {k: v.unbind(0) for k, v in named.items()}
        return [{k: v[i] for k, v in per.items()}
                for i in range(self.n_layer)]

    def forward(self, x: torch.Tensor, *args, remat: bool = False,
                **kwargs) -> torch.Tensor:
        for p in self.layer_params():
            if remat:
                x, _ = remat_block(self.block, p, x, *args, **kwargs)
            else:
                x, _ = torch.func.functional_call(
                    self.block, p, (x, *args), kwargs, strict=True)
        return x


def refuse_scan_generation(cfg) -> None:
    """Generation needs the unrolled layout (JAX ``models/gpt2.py:222``)."""
    if cfg.scan_blocks:
        raise ValueError(
            "KV-cache generation needs the unrolled block layout; "
            "rebuild the serving model with scan_blocks=False "
            "(wire artifacts are unrolled already)")


def _tp_enter(h: torch.Tensor, tp) -> torch.Tensor:
    """Megatron's f on a value replicated over tp whose uses on each tp
    rank are partial: the identity, whose backward sums over tp."""
    if tp is None:
        return h
    from ..parallel.collectives import copy_to
    return copy_to(h, tp, "tp")


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
        if cfg.scan_blocks:
            self.h = BlockScan(Block(cfg), cfg.n_layer)
        else:
            for i in range(cfg.n_layer):
                self.add_module(f"h_{i}", Block(cfg))
        self.ln_f = LayerNorm(cfg.n_embd, cfg)

    def blocks(self) -> list[Block]:
        """The unrolled blocks (the stacked layout has one
        :class:`BlockScan`, ``self.h``)."""
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
        if sow_kv or kv_pages is not None:
            refuse_scan_generation(cfg)
        x = embed_tokens(self.wte, self.wpe, input_ids, position_ids, cfg)
        remat = (cfg.remat and torch.is_grad_enabled() and not sow_kv
                 and kv_pages is None)
        if cfg.scan_blocks:
            x = self.ln_f(self.h(x, attention_mask, segment_ids,
                                 remat=remat))
            return x if return_hidden else tied_logits(x, self.wte, cfg)
        kvs = []
        for i, blk in enumerate(self.blocks()):
            if remat:
                x, kv = remat_block(blk, dict(blk.named_parameters()), x,
                                    attention_mask, segment_ids)
            else:
                x, kv = blk(x, attention_mask, segment_ids,
                            kv_pages=None if kv_pages is None
                            else kv_pages[i],
                            page_tables=page_tables, kv_lens=kv_lens)
            kvs.append(kv)
        x = self.ln_f(x)
        if return_hidden:
            return x
        logits = tied_logits(x, self.wte, cfg)
        return (logits, kvs) if sow_kv else logits


def remat_block(blk: Block, params: Mapping[str, torch.Tensor], x, *args,
                gather=None, **kwargs):
    """``blk(x, *args, **kwargs)`` with ``params`` as its parameters, its
    activations recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant) instead of kept: JAX's ``nn.remat(Block)``. The
    parameters enter as explicit inputs, so the recomputation reads the
    same tensors after ``functional_call`` has restored the module.
    ``gather(params)``, where given, turns them into what the block
    computes with inside the recomputed region (a mesh's gathered
    parameters, gathered again in the backward)."""
    from torch.utils.checkpoint import checkpoint
    names = list(params)

    def run(x, *leaves):
        p = dict(zip(names, leaves))
        if gather is not None:
            p = gather(p)
        return torch.func.functional_call(blk, p, (x, *args), kwargs,
                                          strict=True)

    return checkpoint(run, x, *params.values(), use_reentrant=False)


def embed_tokens(wte: torch.Tensor, wpe: torch.Tensor,
                 input_ids: torch.Tensor, position_ids: torch.Tensor | None,
                 cfg: GPT2Config) -> torch.Tensor:
    """The token and position embeddings summed, in the compute dtype
    (``position_ids`` defaults to ``arange(T)``)."""
    if position_ids is None:
        position_ids = torch.arange(input_ids.shape[1],
                                    device=input_ids.device)
    x = embed_lookup(wte, input_ids) + embed_lookup(wpe, position_ids)
    return x.to(cfg.compute_dtype())


def tied_logits(x: torch.Tensor, wte: torch.Tensor, cfg: GPT2Config
                ) -> torch.Tensor:
    """The tied head: compute-dtype products, exact in f32, summed in
    f32 (the JAX package's preferred_element_type=float32)."""
    wte = wte.to(cfg.compute_dtype()).float()
    return (x.float() @ wte.T).to(_TORCH_DTYPES[cfg.logits_dtype])


def make_model(preset_or_cfg) -> tuple[GPT2, GPT2Config]:
    """``(GPT2 structure on the meta device, config)``; weights come
    with :func:`bind`."""
    cfg = PRESETS[preset_or_cfg] if isinstance(preset_or_cfg, str) \
        else preset_or_cfg
    return GPT2(cfg), cfg


def draft_compat(cfg: GPT2Config, target_cfg) -> str | None:
    """Why a GPT-2 with this config cannot DRAFT for a target with
    ``target_cfg`` (None = compatible; engine/speculative.py). Proposals
    are raw token ids the target scores verbatim, so the real
    vocabularies must match exactly; the padded vocab may differ
    (sampling slices to ``vocab_size``), and the drafter's position
    capacity is a soft limit (it stops proposing past it)."""
    tv = getattr(target_cfg, "vocab_size", None)
    if cfg.vocab_size != tv:
        return (f"draft vocab_size {cfg.vocab_size} != target "
                f"vocab_size {tv}: proposal ids would not name the "
                "same tokens")
    return None


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
    """The JAX package's param tree of either family (nested dicts of
    arrays, or CPU tensors for bf16 leaves: GPT-2's
    ``h_{i}/c_attn/kernel``, ``ln_1/scale``, ``wte``; Llama's
    ``layer_{i}/wq/kernel``, ``lm_head``, ...; the scan layout's
    ``h/block/...`` or ``layers/block/...``) as a state dict keyed by
    the ``.``-joined paths, on ``device`` (``"cuda"`` unless the caller
    asks for the CPU). Values, dtypes and layouts are unchanged."""
    device = resolve_device(device)
    state: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            path = f"{prefix}{key}"
            if isinstance(val, Mapping):
                walk(val, path + ".")
            elif isinstance(val, torch.Tensor):   # bf16 leaves off the wire
                state[path] = val.detach().to(device, copy=True)
            else:
                # a private, writable, C-ordered copy (arrays handed over
                # from JAX are read-only views)
                state[path] = torch.from_numpy(np.array(val, order="C")
                                               ).to(device)

    walk(tree, "")
    return state


def params_to_numpy(state: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_numpy`: the nested numpy tree (a
    bf16 leaf as a CPU tensor: numpy has no bf16 on the card machine)."""
    tree: dict = {}
    for path, t in state.items():
        *parents, leaf = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        t = t.detach().cpu()
        node[leaf] = t if t.dtype == torch.bfloat16 else t.numpy()
    return tree


def init_params_numpy(cfg: GPT2Config, seed: int) -> dict:
    """Random weights in the JAX package's tree and init distributions
    (normal 0.02 for dense kernels and ``wte``, 0.01 for ``wpe``,
    ones/zeros for LayerNorm, zero biases), drawn with numpy from
    ``seed``; stacked (:func:`stack_blocks`) when ``cfg.scan_blocks``,
    the same values as the unrolled draw. The draws differ from
    ``jax.random``'s; the distributions and layouts do not."""
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
    return stack_blocks(tree, cfg.n_layer) if cfg.scan_blocks else tree


# ---------------------------------------------------------------------------
# The block layouts: unrolled (h_0..h_{L-1}) <-> stacked (h/block, [L, ...])
# ---------------------------------------------------------------------------

def _stack(xs: list):
    """Host numpy stays host numpy (an averager may hold ~100 fetched
    deltas before its merge); tensors stack where they are."""
    if xs[0] is None:
        return None
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack(xs)


def _map_leaves(fn, *trees):
    if isinstance(trees[0], Mapping):
        return {k: _map_leaves(fn, *(t[k] for t in trees))
                for k in trees[0]}
    return fn(*trees)


def _is_nested(params: Mapping, key: str) -> bool:
    return isinstance(params.get(key), Mapping)


def stack_blocks(params: Mapping, n_layer: int, *, prefix: str = "h_",
                 scan_key: str = "h") -> dict:
    """Unrolled layout (``h_0..h_{L-1}``) -> scan layout (``h/block``,
    each per-block leaf gaining a leading ``[L]`` axis): JAX's
    ``stack_blocks``. ``params`` is a nested tree (the JAX spelling) or
    a flat state dict (``h_0.c_attn.kernel`` -> ``h.block.c_attn.
    kernel``, at the position of the first block's keys). Numpy stays
    numpy; None leaves (an adapter tree's) stay None."""
    def is_block(k: str) -> bool:
        head = k.split(".", 1)[0]
        return head.startswith(prefix) and head[len(prefix):].isdigit()

    if _is_nested(params, f"{prefix}0"):
        # the stack takes the first block's place (a state dict of it
        # then lists the model's parameters in the model's order)
        out = {}
        for k, v in params.items():
            if k == f"{prefix}0":
                out[scan_key] = {"block": _map_leaves(
                    lambda *xs: _stack(list(xs)),
                    *(params[f"{prefix}{i}"] for i in range(n_layer)))}
            elif not is_block(k):
                out[k] = v
        return out
    first = f"{prefix}0."
    rests = [k[len(first):] for k in params if k.startswith(first)]
    out = {}
    for k, v in params.items():
        if k.startswith(first):
            rest = k[len(first):]
            out[f"{scan_key}.block.{rest}"] = _stack(
                [params[f"{prefix}{i}.{rest}"] for i in range(n_layer)])
        elif not is_block(k):
            out[k] = v
    if not rests:
        raise KeyError(f"no {prefix}0 block in the tree")
    return out


def unstack_blocks(params: Mapping, n_layer: int, *, prefix: str = "h_",
                   scan_key: str = "h") -> dict:
    """Scan layout -> unrolled layout (the inverse of
    :func:`stack_blocks`): each layer's leaves are index views of the
    stacked ones (numpy stays numpy, no copies)."""
    if _is_nested(params, scan_key):
        out = {}
        for k, v in params.items():
            if k != scan_key:
                out[k] = v
                continue
            for i in range(n_layer):
                out[f"{prefix}{i}"] = _map_leaves(
                    lambda x, i=i: None if x is None else x[i], v["block"])
        return out
    head = f"{scan_key}.block."
    rests = [k[len(head):] for k in params if k.startswith(head)]
    out = {}
    for k, v in params.items():
        if not k.startswith(head):
            out[k] = v
        elif k[len(head):] == rests[0]:
            for i in range(n_layer):
                for rest in rests:
                    x = params[head + rest]
                    out[f"{prefix}{i}.{rest}"] = None if x is None else x[i]
    return out
