"""HF checkpoint import and export — the port of the JAX package's
``models/convert.py`` (``--init-from``).

The reference fine-tunes a *pretrained* GPT-2
(``AutoModelForCausalLM.from_pretrained``); this module maps an HF
checkpoint's tensors (safetensors, or a torch ``.bin`` / ``.pt``) onto
the port's GPT-2 and Llama trees and back, so a role can start from
``--init-from hf:openai-community/gpt2`` and an exported base loads in
stock ``transformers``. It imports none of ``safetensors``,
``huggingface_hub`` or ``transformers``: safetensors files are parsed
by ``serialization.parse_safetensors`` over an ``mmap`` of each file
(a shard's bytes are read from the page cache, never copied whole),
and ``hf:<repo_id>`` resolves against the local HF cache by hand, as
``huggingface_hub.snapshot_download(local_files_only=True)`` resolves
it. Nothing here touches the network.

Shape contracts (as JAX's):

- vocabulary padding: the models store ``padded_vocab`` rows, HF the
  real vocabulary; import zero-pads the tail rows, export slices them
  off;
- GPT-2's ``Conv1D`` weights are ``[in, out]`` already (the fused
  ``c_attn`` in q|k|v order), so they copy as they are; Llama's
  ``nn.Linear`` weights are ``[out, in]`` and are transposed;
- GPT-2's head is tied: ``lm_head.weight`` is not read, and export
  writes it as ``wte``; a Llama checkpoint without ``lm_head.weight``
  (tied embeddings) takes a copy of ``wte``;
- RoPE: HF stores q/k in the rotate-half convention the models use, so
  they import by transposing alone.

The trees are nested dicts of numpy arrays in the storage dtype (the
wire tree ``models.params_from_numpy`` takes); :func:`load_params`
stacks the blocks when the config runs the scan layout.
"""

from __future__ import annotations

import mmap
import os
from typing import Any, Mapping

import numpy as np
import torch

Params = Any

_WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")


# ---------------------------------------------------------------------------
# Sources: a spec -> a flat {name: array}
# ---------------------------------------------------------------------------

def _to_numpy(t) -> np.ndarray:
    """A tensor or array-like as numpy (bf16 as f32: numpy has no bf16
    on the card machine, and the parameters are stored in f32)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def _load_safetensors_file(path: str) -> dict:
    """One safetensors file as ``{name: array}`` over an mmap of it (a
    BF16 tensor as a ``torch.bfloat16`` view)."""
    from .. import serialization as ser
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            return ser.parse_safetensors(b"")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return ser.parse_safetensors(mm)


def _load_torch_file(path: str) -> dict:
    # weights_only: never unpickle arbitrary objects from a checkpoint
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _to_numpy(v) for k, v in state.items()}


def hf_cache_dir() -> str:
    """The local HF hub cache, in ``huggingface_hub``'s order:
    ``HF_HUB_CACHE``, then ``HUGGINGFACE_HUB_CACHE``, then
    ``$HF_HOME/hub``, with ``HF_HOME`` defaulting to
    ``$XDG_CACHE_HOME/huggingface`` (``~/.cache/huggingface``)."""
    def expand(p: str) -> str:
        return os.path.expandvars(os.path.expanduser(p))

    home = expand(os.getenv("HF_HOME", os.path.join(
        os.getenv("XDG_CACHE_HOME",
                  os.path.join(os.path.expanduser("~"), ".cache")),
        "huggingface")))
    legacy = os.getenv("HUGGINGFACE_HUB_CACHE", os.path.join(home, "hub"))
    return expand(os.getenv("HF_HUB_CACHE", legacy))


def resolve_hf(repo_id: str, *, cache_dir: str | None = None,
               revision: str = "main") -> str:
    """``hf:<repo_id>``'s snapshot directory in the local cache:
    ``models--<org>--<name>/refs/<revision>`` names the commit, and
    ``snapshots/<commit>/`` must exist. An absent entry raises
    FileNotFoundError; nothing is fetched."""
    cache = cache_dir or hf_cache_dir()
    folder = os.path.join(cache, "models--" + repo_id.replace("/", "--"))
    ref = os.path.join(folder, "refs", revision)
    if os.path.exists(ref):
        with open(ref) as f:
            commit = f.read()
        snap = os.path.join(folder, "snapshots", commit)
        if os.path.exists(snap):
            return snap
    raise FileNotFoundError(
        f"hf:{repo_id} has no cached snapshot for {revision!r} under "
        f"{cache} (no network access: lay the checkpoint out in the "
        f"local HF cache, or pass a directory or a file)")


def load_flat(source) -> dict:
    """A flat HF-style state dict from any supported source:

    - a mapping (a torch ``state_dict()`` or ``{name: array}``);
    - a ``.safetensors``, ``.bin`` or ``.pt`` file;
    - a checkpoint directory: every ``*.safetensors`` shard, else
      ``model.safetensors`` / ``pytorch_model.bin``;
    - ``hf:<repo_id>``, resolved from the local HF cache only
      (:func:`resolve_hf`).

    Safetensors values are views of the file (BF16 ones torch tensors);
    the converters copy what they take."""
    if isinstance(source, Mapping):
        return {k: _to_numpy(v) for k, v in source.items()}
    if not isinstance(source, (str, os.PathLike)):
        raise TypeError(f"unsupported source {type(source)}")
    spec = os.fspath(source)
    if spec.startswith("hf:"):
        spec = resolve_hf(spec[3:])
    if os.path.isdir(spec):
        shards = sorted(f for f in os.listdir(spec)
                        if f.endswith(".safetensors"))
        if shards:
            flat: dict = {}
            for f in shards:
                flat.update(_load_safetensors_file(os.path.join(spec, f)))
            return flat
        for name in _WEIGHT_FILES:
            p = os.path.join(spec, name)
            if os.path.exists(p):
                return load_flat(p)
        raise FileNotFoundError(f"no weight files under {spec}")
    if spec.endswith(".safetensors"):
        return _load_safetensors_file(spec)
    return _load_torch_file(spec)


def _as_array(x, dt: np.dtype, transpose: bool = False) -> np.ndarray:
    """A private C-ordered copy of a source leaf in the storage dtype,
    transposed where asked: one pass over the leaf (a 7B checkpoint's
    conversion is host-bound)."""
    if isinstance(x, torch.Tensor):
        t = x.T if transpose else x
        out = np.empty(tuple(t.shape), dt)
        torch.from_numpy(out).copy_(t)
        return out
    x = np.asarray(x)
    return np.array(x.T if transpose else x, dtype=dt, order="C")


def _pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    if x.shape[0] == rows:
        return x
    if x.shape[0] > rows:
        raise ValueError(f"vocab {x.shape[0]} exceeds padded target {rows}")
    pad = np.zeros((rows - x.shape[0],) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad], axis=0)


def _strip_prefix(flat: Mapping, prefix: str) -> dict:
    if any(k.startswith(prefix) for k in flat):
        return {k[len(prefix):] if k.startswith(prefix) else k: v
                for k, v in flat.items()}
    return dict(flat)


def _taker(flat: Mapping, cfg):
    dt = np.dtype(cfg.param_dtype)

    def take(name, shape, *, transpose=False, pad_vocab_rows=False):
        if name not in flat:
            raise KeyError(f"checkpoint missing {name!r}")
        x = _as_array(flat[name], dt, transpose)
        if pad_vocab_rows:
            x = _pad_rows(x, cfg.padded_vocab)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {x.shape} != expected {shape}")
        return x

    return take


# ---------------------------------------------------------------------------
# GPT-2
# ---------------------------------------------------------------------------

def gpt2_from_hf(source, cfg) -> Params:
    """An HF GPT-2 checkpoint as the port's GPT-2 tree (``cfg`` must
    match its architecture; shapes are checked leaf by leaf)."""
    take = _taker(_strip_prefix(load_flat(source), "transformer."), cfg)
    E = cfg.n_embd
    params: dict = {
        "wte": take("wte.weight", (cfg.padded_vocab, E), pad_vocab_rows=True),
        "wpe": take("wpe.weight", (cfg.n_positions, E)),
        "ln_f": {"scale": take("ln_f.weight", (E,)),
                 "bias": take("ln_f.bias", (E,))},
    }
    for i in range(cfg.n_layer):
        p = f"h.{i}."
        params[f"h_{i}"] = {
            "ln_1": {"scale": take(p + "ln_1.weight", (E,)),
                     "bias": take(p + "ln_1.bias", (E,))},
            # HF's Conv1D stores (in, out), as the port's kernels
            "c_attn": {"kernel": take(p + "attn.c_attn.weight", (E, 3 * E)),
                       "bias": take(p + "attn.c_attn.bias", (3 * E,))},
            "c_proj": {"kernel": take(p + "attn.c_proj.weight", (E, E)),
                       "bias": take(p + "attn.c_proj.bias", (E,))},
            "ln_2": {"scale": take(p + "ln_2.weight", (E,)),
                     "bias": take(p + "ln_2.bias", (E,))},
            "c_fc": {"kernel": take(p + "mlp.c_fc.weight", (E, 4 * E)),
                     "bias": take(p + "mlp.c_fc.bias", (4 * E,))},
            "mlp_proj": {"kernel": take(p + "mlp.c_proj.weight", (4 * E, E)),
                         "bias": take(p + "mlp.c_proj.bias", (E,))},
        }
    return params


def gpt2_to_hf(params: Params, cfg) -> dict:
    """The inverse of :func:`gpt2_from_hf`: a ``GPT2LMHeadModel`` state
    dict (``transformer.*`` and the tied ``lm_head.weight``), the
    vocabulary padding sliced off."""
    V = cfg.vocab_size
    out = {
        "transformer.wte.weight": _to_numpy(params["wte"])[:V],
        "transformer.wpe.weight": _to_numpy(params["wpe"]),
        "transformer.ln_f.weight": _to_numpy(params["ln_f"]["scale"]),
        "transformer.ln_f.bias": _to_numpy(params["ln_f"]["bias"]),
    }
    names = (("ln_1", "scale", "ln_1.weight"), ("ln_1", "bias", "ln_1.bias"),
             ("c_attn", "kernel", "attn.c_attn.weight"),
             ("c_attn", "bias", "attn.c_attn.bias"),
             ("c_proj", "kernel", "attn.c_proj.weight"),
             ("c_proj", "bias", "attn.c_proj.bias"),
             ("ln_2", "scale", "ln_2.weight"), ("ln_2", "bias", "ln_2.bias"),
             ("c_fc", "kernel", "mlp.c_fc.weight"),
             ("c_fc", "bias", "mlp.c_fc.bias"),
             ("mlp_proj", "kernel", "mlp.c_proj.weight"),
             ("mlp_proj", "bias", "mlp.c_proj.bias"))
    for i in range(cfg.n_layer):
        b = params[f"h_{i}"]
        for mod, leaf, dst in names:
            out[f"transformer.h.{i}.{dst}"] = _to_numpy(b[mod][leaf])
    out["lm_head.weight"] = out["transformer.wte.weight"]   # tied
    return out


# ---------------------------------------------------------------------------
# Llama
# ---------------------------------------------------------------------------

def llama_from_hf(source, cfg) -> Params:
    """An HF Llama checkpoint as the port's Llama tree (``nn.Linear``'s
    ``[out, in]`` weights transposed to ``[in, out]`` kernels)."""
    flat = load_flat(source)
    take = _taker(flat, cfg)
    E, D = cfg.n_embd, cfg.head_dim
    Hq, Hkv, I = cfg.n_head, cfg.n_kv_head, cfg.intermediate_size
    params: dict = {
        "wte": take("model.embed_tokens.weight", (cfg.padded_vocab, E),
                    pad_vocab_rows=True),
        "final_norm": {"scale": take("model.norm.weight", (E,))},
    }
    if "lm_head.weight" in flat:
        params["lm_head"] = take("lm_head.weight", (cfg.padded_vocab, E),
                                 pad_vocab_rows=True)
    else:   # tied-embedding checkpoints
        params["lm_head"] = params["wte"].copy()
    for i in range(cfg.n_layer):
        p = f"model.layers.{i}."
        params[f"layer_{i}"] = {
            "attn_norm": {"scale": take(p + "input_layernorm.weight", (E,))},
            "wq": {"kernel": take(p + "self_attn.q_proj.weight",
                                  (E, Hq * D), transpose=True)},
            "wk": {"kernel": take(p + "self_attn.k_proj.weight",
                                  (E, Hkv * D), transpose=True)},
            "wv": {"kernel": take(p + "self_attn.v_proj.weight",
                                  (E, Hkv * D), transpose=True)},
            "wo": {"kernel": take(p + "self_attn.o_proj.weight",
                                  (Hq * D, E), transpose=True)},
            "mlp_norm": {"scale": take(p + "post_attention_layernorm.weight",
                                       (E,))},
            "w_gate": {"kernel": take(p + "mlp.gate_proj.weight", (E, I),
                                      transpose=True)},
            "w_up": {"kernel": take(p + "mlp.up_proj.weight", (E, I),
                                    transpose=True)},
            "w_down": {"kernel": take(p + "mlp.down_proj.weight", (I, E),
                                      transpose=True)},
        }
    return params


def llama_to_hf(params: Params, cfg) -> dict:
    """The inverse of :func:`llama_from_hf` (``LlamaForCausalLM``'s
    state dict)."""
    V = cfg.vocab_size
    out = {
        "model.embed_tokens.weight": _to_numpy(params["wte"])[:V],
        "model.norm.weight": _to_numpy(params["final_norm"]["scale"]),
        "lm_head.weight": _to_numpy(params["lm_head"])[:V],
    }
    for i in range(cfg.n_layer):
        layer = params[f"layer_{i}"]
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = \
            _to_numpy(layer["attn_norm"]["scale"])
        out[p + "post_attention_layernorm.weight"] = \
            _to_numpy(layer["mlp_norm"]["scale"])
        for src, dst in (("wq", "self_attn.q_proj"),
                         ("wk", "self_attn.k_proj"),
                         ("wv", "self_attn.v_proj"),
                         ("wo", "self_attn.o_proj"),
                         ("w_gate", "mlp.gate_proj"),
                         ("w_up", "mlp.up_proj"),
                         ("w_down", "mlp.down_proj")):
            out[p + dst + ".weight"] = _to_numpy(layer[src]["kernel"]).T
    return out


# ---------------------------------------------------------------------------
# --init-from
# ---------------------------------------------------------------------------

def load_params(spec, model_cfg) -> Params:
    """``--init-from``'s spec resolved against the model config in use:
    the family's converter, then :func:`models.stack_blocks` when the
    config runs the scan layout."""
    from . import gpt2, llama
    if isinstance(model_cfg, gpt2.GPT2Config):
        params = gpt2_from_hf(spec, model_cfg)
        if model_cfg.scan_blocks:
            params = gpt2.stack_blocks(params, model_cfg.n_layer)
        return params
    if isinstance(model_cfg, llama.LlamaConfig):
        params = llama_from_hf(spec, model_cfg)
        if model_cfg.scan_blocks:
            params = llama.stack_blocks(params, model_cfg.n_layer)
        return params
    raise TypeError(f"no converter for {type(model_cfg).__name__}")
