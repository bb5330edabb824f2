"""The port's safetensors codec (distributedtraining_tpu_torch/
serialization.py) and HF checkpoint converters (models/convert.py,
``--init-from``) against the JAX package's, on the CPU.

The port reads and writes safetensors itself and resolves ``hf:``
against the local HF cache by hand (the card machine has neither
``safetensors`` nor ``huggingface_hub`` nor ``transformers``); here those
packages are the oracles. Checkpoints are tiny ``transformers`` models
with random weights, saved in f32 and bf16 as one file, as shards, as a
``.bin``, in a laid-out HF cache and as a state dict: no weights are
fetched.
"""

import copy
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from distributedtraining_tpu import serialization as jser  # noqa: E402
from distributedtraining_tpu.models import convert as jconv  # noqa: E402
from distributedtraining_tpu.models import gpt2 as jg  # noqa: E402
from distributedtraining_tpu.models import llama as jl  # noqa: E402
from distributedtraining_tpu_torch import models  # noqa: E402
from distributedtraining_tpu_torch import serialization as tser  # noqa: E402
from distributedtraining_tpu_torch.models import convert as tconv  # noqa
from distributedtraining_tpu_torch.models import gpt2 as tg  # noqa: E402
from distributedtraining_tpu_torch.models import llama as tl  # noqa: E402

COMMIT = "0123456789abcdef0123456789abcdef01234567"


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

def _mixed_trees():
    """The same tree as JAX holds it and as the port holds it (bf16 a
    jnp array there, a torch tensor here): f32, bf16, int8, int32 and
    uint8 leaves, a 0-d leaf and an empty one."""
    rng = np.random.default_rng(0)
    bf = rng.standard_normal((4, 2)).astype(np.float32)
    common = {
        "w": {"kernel": rng.standard_normal((3, 5)).astype(np.float32)},
        "q": rng.integers(-128, 127, (7,)).astype(np.int8),
        "idx": rng.integers(-1000, 1000, (2, 2)).astype(np.int32),
        "m": rng.integers(0, 255, (5,)).astype(np.uint8),
        "s": np.array(1.5, np.float32),
        "e": np.zeros((0, 3), np.float32),
    }
    jtree = {**common, "bf": jnp.asarray(bf, jnp.bfloat16)}
    ttree = {**common, "bf": torch.from_numpy(bf).to(torch.bfloat16)}
    return jtree, ttree


def _trees(which):
    if which == "mixed":
        return _mixed_trees()
    tree = tg.init_params_numpy(tg.PRESETS["tiny"], 0)
    return tree, tree


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32) if np.asarray(x).dtype.name \
        == "bfloat16" else np.asarray(x)


def _same_flat(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        x, y = _f32(a[k]), _f32(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("which", ["mixed", "params"])
def test_safetensors_bytes_equal_and_each_parses_the_other(which):
    jtree, ttree = _trees(which)
    want = jser.to_safetensors(jtree)
    got = tser.to_safetensors(ttree)
    assert got == want
    # the port parses JAX's bytes, JAX parses the port's
    _same_flat(tser.from_safetensors(want), jser.from_safetensors(got))
    _same_flat(tser.flatten_tree(ttree), tser.from_safetensors(want))
    back = tser.from_safetensors(got, template=ttree)
    assert set(back) == set(ttree)
    _same_flat(tser.flatten_tree(back), tser.flatten_tree(ttree))


def test_safetensors_of_an_empty_tree():
    assert tser.to_safetensors({}) == jser.to_safetensors({})


def _st(header: dict, buf: bytes, n: int | None = None) -> bytes:
    text = json.dumps(header).encode()
    return (len(text) if n is None else n).to_bytes(8, "little") + text + buf


def _hostile():
    buf = np.arange(6, dtype=np.float32).tobytes()
    ok = {"a": {"dtype": "F32", "shape": [2, 3], "data_offsets": [0, 24]}}
    return {
        "truncated": jser.to_safetensors({"a": np.zeros(3, np.float32)})[:5],
        "header_past_data": _st(ok, buf, n=10_000),
        "header_cap": (200 * 1024 * 1024).to_bytes(8, "little"),
        "offsets_past_end": _st({"a": {**ok["a"], "data_offsets": [0, 28]}},
                                buf),
        "short_offsets": _st({"a": {**ok["a"], "data_offsets": [0, 20]}},
                             buf),
        "reversed_offsets": _st({"a": {**ok["a"],
                                       "data_offsets": [24, 0]}}, buf),
        "unknown_dtype": _st({"a": {**ok["a"], "dtype": "C64"}}, buf),
        "bad_json": (5).to_bytes(8, "little") + b"{not json" + buf,
        "no_dtype": _st({"a": {"shape": [2, 3], "data_offsets": [0, 24]}},
                        buf),
        # JAX does not refuse two tensors over the same bytes: neither
        # does the port
        "overlapping": _st({**ok, "b": dict(ok["a"])}, buf),
    }


@pytest.mark.parametrize("case", sorted(_hostile()))
def test_malformed_safetensors_verdicts_equal_jax(case):
    data = _hostile()[case]

    def verdict(mod):
        try:
            mod.from_safetensors(data)
            return "ok"
        except mod.PayloadError:
            return "refused"

    want = verdict(jser)
    assert verdict(tser) == want
    assert want == ("ok" if case == "overlapping" else "refused")


def test_safetensors_file_round_trip_and_validated_load(tmp_path):
    jtree, ttree = _mixed_trees()
    path = str(tmp_path / "sub" / "tree.safetensors")
    tser.save_file(ttree, path)
    assert not list((tmp_path / "sub").glob("*.tmp"))
    raw = open(path, "rb").read()
    assert raw == jser.to_safetensors(jtree)
    _same_flat(tser.flatten_tree(tser.load_file(path, ttree)),
               tser.flatten_tree(ttree))
    # check_dtypes pins every leaf to the template's dtype, in both
    tmpl = {"q": np.zeros(4, np.int8)}
    good = tser.to_safetensors({"q": np.arange(4, dtype=np.int8)})
    bad = tser.to_safetensors({"q": np.arange(4, dtype=np.float32)})
    assert np.array_equal(tser.validated_load(
        good, tmpl, fmt="safetensors", check_dtypes=True)["q"],
        np.arange(4))
    for mod in (tser, jser):
        with pytest.raises(mod.PayloadError):
            mod.validated_load(bad, tmpl, fmt="safetensors",
                               check_dtypes=True)
    for mod in (tser, jser):   # a missing tensor, by name
        with pytest.raises(mod.PayloadError, match="missing tensor"):
            mod.from_safetensors(good, {"q": np.zeros(4, np.int8),
                                        "r": np.zeros(1, np.int8)})


# ---------------------------------------------------------------------------
# The converters
# ---------------------------------------------------------------------------

V = 500   # padded to 512: the import pads, the export slices


def _hf_gpt2(vocab=V):
    cfg = transformers.GPT2Config(
        vocab_size=vocab, n_positions=128, n_embd=64, n_layer=2, n_head=4,
        activation_function="gelu_new", resid_pdrop=0.0, embd_pdrop=0.0,
        attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _hf_llama(tied: bool):
    cfg = transformers.LlamaConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
        max_position_embeddings=128, rope_theta=10000.0,
        attention_dropout=0.0, tie_word_embeddings=tied, rms_norm_eps=1e-5)
    torch.manual_seed(1)
    return transformers.LlamaForCausalLM(cfg).eval()


def _cfgs(family, **kw):
    """(port config, JAX config) of the HF test models' architecture."""
    if family == "gpt2":
        args = dict(vocab_size=V, n_positions=128, n_embd=64, n_layer=2,
                    n_head=4, dtype="float32", **kw)
        return tg.GPT2Config(**args), jg.GPT2Config(**args)
    args = dict(vocab_size=V, max_seq_len=128, n_embd=64, n_layer=2,
                n_head=4, n_kv_head=2, intermediate_size=128, remat=False,
                dtype="float32", **kw)
    return tl.LlamaConfig(**args), jl.LlamaConfig(**args)


FAMILIES = {"gpt2": lambda: _hf_gpt2(),
            "llama": lambda: _hf_llama(tied=False),
            "llama-tied": lambda: _hf_llama(tied=True)}


@pytest.fixture(scope="module")
def hf_models():
    return {name: make() for name, make in FAMILIES.items()}


def _state(hf, family, dtype):
    sd = {k: v.to(getattr(torch, dtype)) for k, v in hf.state_dict().items()}
    if family == "llama-tied":
        sd.pop("lm_head.weight", None)
    return sd


def _hf_cache(root, repo_id: str, files: dict) -> str:
    """A local HF hub cache holding ``repo_id`` at COMMIT with
    ``files`` (name -> source path); its root."""
    folder = os.path.join(root, "models--" + repo_id.replace("/", "--"))
    snap = os.path.join(folder, "snapshots", COMMIT)
    os.makedirs(snap)
    os.makedirs(os.path.join(folder, "refs"))
    with open(os.path.join(folder, "refs", "main"), "w") as f:
        f.write(COMMIT)
    for name, src in files.items():
        shutil.copy(src, os.path.join(snap, name))
    return root


@pytest.fixture(scope="module")
def sources(hf_models, tmp_path_factory):
    """family -> dtype -> kind -> the spec both packages load (the cache
    root of the ``hf`` kind is set by the test)."""
    out = {}
    for family, hf in hf_models.items():
        for dtype in ("float32", "bfloat16"):
            d = tmp_path_factory.mktemp(f"{family}-{dtype}")
            sd = _state(hf, family, dtype)
            # a copy: a cast and back would round the shared model's
            # buffers (RoPE's inv_freq) through bf16
            model = copy.deepcopy(hf).to(getattr(torch, dtype))
            one, shards, binary = d / "one", d / "shards", d / "bin"
            model.save_pretrained(one)
            model.save_pretrained(shards, max_shard_size="100KB")
            model.save_pretrained(binary, safe_serialization=False)
            shard_files = {f: shards / f for f in os.listdir(shards)
                           if f.endswith(".safetensors")}
            assert len(shard_files) > 1
            cache = _hf_cache(str(d / "hub"), f"test-org/{family}",
                              shard_files)
            out.setdefault(family, {})[dtype] = {
                "state_dict": sd,
                "one_file": str(one / "model.safetensors"),
                "shards": str(shards),
                "bin": str(binary / "pytorch_model.bin"),
                "hf": (cache, f"hf:test-org/{family}"),
            }
    return out


def _spec(src, kind, monkeypatch):
    if kind != "hf":
        return src
    import huggingface_hub.constants as hconst
    cache, spec = src
    monkeypatch.setenv("HF_HUB_CACHE", cache)
    monkeypatch.setattr(hconst, "HF_HUB_CACHE", cache)
    return spec


def _flat_np(tree) -> dict:
    return {".".join(str(p) for p in path): np.asarray(leaf)
            for path, leaf in _walk(tree)}


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("kind", ["state_dict", "one_file", "shards", "bin",
                                  "hf"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_load_params_equals_jax_bit_for_bit(sources, monkeypatch, family,
                                           dtype, kind):
    spec = _spec(sources[family][dtype][kind], kind, monkeypatch)
    tcfg, jcfg = _cfgs(family.split("-")[0])
    got = _flat_np(tconv.load_params(spec, tcfg))
    want = _flat_np(jconv.load_params(spec, jcfg))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert np.all(got["wte"][V:] == 0)     # the padded rows
    if family == "llama-tied":
        assert np.array_equal(got["lm_head"], got["wte"])


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_load_params_stacks_for_scan_as_jax(sources, family):
    spec = sources[family]["float32"]["shards"]
    tcfg, jcfg = _cfgs(family, scan_blocks=True)
    got = _flat_np(tconv.load_params(spec, tcfg))
    want = _flat_np(jconv.load_params(spec, jcfg))
    assert set(got) == set(want)
    key = "h" if family == "gpt2" else "layers"
    assert any(k.startswith(f"{key}.block.") for k in got)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_match_transformers(hf_models, family):
    hf = hf_models[family]
    tcfg, _ = _cfgs(family.split("-")[0])
    tree = tconv.load_params(_state(hf, family, "float32"), tcfg)
    model, _ = models.make_model(tcfg)
    state = models.params_from_numpy(tree, device="cpu")
    ids = np.random.default_rng(0).integers(0, V, (2, 16))
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids)).logits.numpy()
        got = torch.func.functional_call(model, state,
                                         (torch.from_numpy(ids),)).numpy()
    np.testing.assert_allclose(got[..., :V], ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_to_hf_equals_jax_and_loads_strictly(hf_models, family):
    hf = hf_models[family]
    fam = family.split("-")[0]
    tcfg, jcfg = _cfgs(fam)
    tree = tconv.load_params(_state(hf, family, "float32"), tcfg)
    to_t = tconv.gpt2_to_hf if fam == "gpt2" else tconv.llama_to_hf
    to_j = jconv.gpt2_to_hf if fam == "gpt2" else jconv.llama_to_hf
    got, want = to_t(tree, tcfg), to_j(tree, jcfg)
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(got[k], want[k]) and \
            got[k].shape == want[k].shape, k
    fresh = FAMILIES[family]()
    fresh.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in got.items()}, strict=True)
    ref = hf.state_dict()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, ref[k]), k
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, V, (2, 16)))
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(ids).logits.numpy(),
                                      hf(ids).logits.numpy())


def _error(fn, *args):
    try:
        fn(*args)
    except (KeyError, ValueError) as e:
        return type(e), str(e)
    return None


def test_shape_and_missing_key_errors_match_jax(hf_models):
    sd = hf_models["gpt2"].state_dict()
    wide_t, wide_j = _cfgs("gpt2")
    wide_t = dataclasses.replace(wide_t, n_embd=128)
    wide_j = dataclasses.replace(wide_j, n_embd=128)
    got = _error(tconv.gpt2_from_hf, sd, wide_t)
    assert got is not None and got[0] is ValueError
    assert got == _error(jconv.gpt2_from_hf, sd, wide_j)
    got = _error(tconv.gpt2_from_hf, {}, tg.PRESETS["tiny"])
    assert got is not None and got[0] is KeyError
    assert got == _error(jconv.gpt2_from_hf, {}, jg.PRESETS["tiny"])
    lsd = dict(hf_models["llama"].state_dict())
    lsd.pop("model.layers.1.mlp.up_proj.weight")
    tcfg, jcfg = _cfgs("llama")
    got = _error(tconv.llama_from_hf, lsd, tcfg)
    assert got is not None and got[0] is KeyError
    assert got == _error(jconv.llama_from_hf, lsd, jcfg)
    small = {"wte.weight": np.zeros((600, 64), np.float32)}   # > padded
    assert _error(tconv._pad_rows, small["wte.weight"], 512) == \
        _error(jconv._pad_rows, small["wte.weight"], 512)


def test_hf_spec_resolves_as_huggingface_hub(tmp_path, monkeypatch):
    from huggingface_hub import snapshot_download
    src = tmp_path / "w.safetensors"
    tser.save_file({"x": np.zeros(2, np.float32)}, str(src))
    cache = _hf_cache(str(tmp_path / "hub"), "org/name",
                      {"model.safetensors": src})
    want = snapshot_download("org/name", local_files_only=True,
                             cache_dir=cache)
    for var in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE", "HF_HOME",
                "XDG_CACHE_HOME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HF_HUB_CACHE", cache)
    assert tconv.resolve_hf("org/name") == want
    # HF_HUB_CACHE wins over HF_HOME; without it, HF_HOME/hub
    monkeypatch.setenv("HF_HOME", str(tmp_path / "elsewhere"))
    assert tconv.hf_cache_dir() == cache
    monkeypatch.delenv("HF_HUB_CACHE")
    assert tconv.hf_cache_dir() == str(tmp_path / "elsewhere" / "hub")
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    os.rename(cache, str(tmp_path / "hub2"))
    os.symlink(str(tmp_path / "hub2"), str(tmp_path / "hub"))
    assert tconv.resolve_hf("org/name") == want
    # an absent entry raises in both, and nothing is fetched
    for repo in ("org/absent", "org/name@x"):
        with pytest.raises(FileNotFoundError):
            tconv.load_flat(f"hf:{repo}")
        with pytest.raises(FileNotFoundError):
            snapshot_download(repo.split("@")[0] if "@" not in repo
                              else "org/absent", local_files_only=True,
                              cache_dir=str(tmp_path / "hub"))
    flat = tconv.load_flat("hf:org/name")
    assert np.array_equal(flat["x"], np.zeros(2, np.float32))
    # a directory without weight files, and a missing shard, raise
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tconv.load_flat(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        tconv.load_flat(str(tmp_path / "nope.safetensors"))


# ---------------------------------------------------------------------------
# The roles' --init-from
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """An HF GPT-2 checkpoint of the ``tiny`` preset's architecture
    (vocab 512, E 64, 2 layers, 4 heads, 128 positions) as one f32
    ``model.safetensors``; its directory."""
    hf = _hf_gpt2(vocab=512)
    d = tmp_path_factory.mktemp("tinyckpt")
    hf.save_pretrained(d)
    return str(d)


def _argv(work, hotkey, ckpt, *extra):
    return ["--backend", "local", "--work-dir", str(work), "--model", "tiny",
            "--dataset", "synthetic", "--tokenizer", "word", "--hotkey",
            hotkey, "--init-from", ckpt, "--batch-size", "4", "--seq-len",
            "32", "--eval-seq-len", "32", "--eval-batches", "2",
            "--no-base-wire-v2", "--flight-events", "0", *extra]


def _cli(module):
    import logging

    def run(argv):
        root = logging.getLogger()
        handlers, level = list(root.handlers), root.level
        try:
            return module.main(argv)
        finally:
            root.handlers[:], root.level = handlers, level
    return run


def _capture(monkeypatch, cls, attr="base_params"):
    """Record ``attr`` of every ``cls`` right after its bootstrap."""
    seen = []
    orig = cls.bootstrap

    def bootstrap(self, *a, **kw):
        orig(self, *a, **kw)
        seen.append({k: v.detach().clone() for k, v in
                     getattr(self, attr).items()})
    monkeypatch.setattr(cls, "bootstrap", bootstrap)
    return seen


def _assert_converted(state, ckpt):
    want = models.params_from_numpy(
        tconv.load_params(ckpt, tg.PRESETS["tiny"]), device="cpu")
    assert set(state) == set(want)
    for k in want:
        assert torch.equal(state[k], want[k]), k


def test_cli_roles_start_from_init_from(tmp_path, monkeypatch, tiny_ckpt):
    """The miner, validator and averager CLIs with ``--init-from`` and
    nothing published start from the converted weights; the averager's
    genesis base is published as those weights."""
    from distributedtraining_tpu_torch.engine.average import AveragerLoop
    from distributedtraining_tpu_torch.engine.train import MinerLoop
    from distributedtraining_tpu_torch.engine.validate import Validator
    from distributedtraining_tpu_torch.neurons import averager, miner
    from distributedtraining_tpu_torch.neurons import validator
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    m_seen = _capture(monkeypatch, MinerLoop)
    v_seen = _capture(monkeypatch, Validator)
    a_seen = _capture(monkeypatch, AveragerLoop)
    assert _cli(miner)(_argv(tmp_path / "m", "hotkey_0", tiny_ckpt,
                             "--max-steps", "2", "--checkpoint-interval",
                             "0", "--no-anomaly-trace")) == 0
    _assert_converted(m_seen[0], tiny_ckpt)
    _cli(validator)(_argv(tmp_path / "v", "hotkey_91", tiny_ckpt,
                          "--rounds", "1"))
    _assert_converted(v_seen[0], tiny_ckpt)
    _cli(averager)(_argv(tmp_path / "a", "hotkey_95", tiny_ckpt,
                         "--rounds", "1", "--no-lineage"))
    _assert_converted(a_seen[0], tiny_ckpt)


def test_averager_genesis_base_bytes_equal_jax(tmp_path, monkeypatch,
                                              tiny_ckpt):
    """Both averagers' genesis bases from one ``--init-from`` are the same
    bytes (a random genesis differs by design: each package draws its
    own)."""
    from neurons import averager as javg

    from distributedtraining_tpu_torch.neurons import averager as tavg
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    for name, mod in (("jax", javg), ("port", tavg)):
        _cli(mod)(_argv(tmp_path / name, "hotkey_95", tiny_ckpt,
                        "--rounds", "1", "--no-lineage"))
    files = [sorted((tmp_path / n / "artifacts" / "base").iterdir())
             for n in ("jax", "port")]
    assert [f.name for f in files[0]] == [f.name for f in files[1]]
    base = [f for f in files[0] if f.suffix == ".msgpack"]
    assert base
    for f in base:
        assert (tmp_path / "port" / "artifacts" / "base" / f.name
                ).read_bytes() == f.read_bytes()


def test_server_serves_init_from_weights(tmp_path, monkeypatch, tiny_ckpt):
    """With nothing published, the server boots on the converted weights
    (scan layout or not: it serves unrolled), and its greedy tokens are
    ``reference_generate``'s over them."""
    from distributedtraining_tpu_torch.config import RunConfig
    from distributedtraining_tpu_torch.engine.serve import (
        BaseRevisionWatcher, GenerationEngine, host_param_template,
        reference_generate)
    from distributedtraining_tpu_torch.neurons import server
    from distributedtraining_tpu_torch.neurons.common import build
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    ref = None
    for scan in (False, True):
        argv = _argv(tmp_path / f"s{scan}", "hotkey_7", tiny_ckpt,
                     "--rounds", "1", "--swap-poll", "0.1")
        cfg = RunConfig.from_args("server", argv + (["--scan-blocks"]
                                                    if scan else []))
        c = build(cfg)
        watcher = BaseRevisionWatcher(
            c.transport, lambda c=c: host_param_template(c.model),
            poll_s=0.1, device="cpu")
        state, rev = server._await_base(cfg, c, watcher, "cpu")
        assert rev is None
        _assert_converted(state, tiny_ckpt)
        engine = GenerationEngine(c.model, state, device="cpu")
        try:
            req = engine.submit([5, 9, 2, 7], 8)
            while req.status not in ("done", "truncated"):
                engine.step()
            toks = list(req.tokens)
        finally:
            engine.close()
            watcher.close()
        cpu_model, _ = models.make_model("tiny")
        assert req.status == "done" and len(toks) == 8
        assert toks == reference_generate(cpu_model, state, [5, 9, 2, 7], 8)
        ref = toks if ref is None else ref
        assert toks == ref


def test_published_base_and_checkpoint_win_over_init_from(tmp_path):
    """The thunk is never called when a base is published (miner,
    validator, averager) or when a checkpoint resumes the miner."""
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.checkpoint import CheckpointStore
    from distributedtraining_tpu_torch.engine.average import (AveragerLoop,
                                                              WeightedAverage)
    from distributedtraining_tpu_torch.engine.train import (MinerLoop,
                                                            TrainEngine)
    from distributedtraining_tpu_torch.engine.validate import Validator
    from distributedtraining_tpu_torch.transport import InMemoryTransport
    calls = []

    def thunk():
        calls.append(1)
        raise AssertionError("the --init-from thunk was called")

    model, cfg = models.make_model("tiny")
    eng = TrainEngine(model, device="cpu")
    t = InMemoryTransport()
    base = tg.init_params_numpy(cfg, 3)
    t.publish_base(base)
    chain = LocalChain(str(tmp_path / "chain"), my_hotkey="hotkey_95",
                       epoch_length=0)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))

    def batches():
        return iter([{"input_ids": ids}])

    MinerLoop(eng, t, "hotkey_0").bootstrap(params=thunk)
    Validator(eng, t, chain, eval_batches=batches).bootstrap(params=thunk)
    AveragerLoop(eng, t, chain, WeightedAverage(),
                 val_batches=batches).bootstrap(params=thunk)
    store = CheckpointStore(str(tmp_path / "ck"))
    m = MinerLoop(eng, InMemoryTransport(), "hotkey_1",
                  checkpoint_store=store)
    m.bootstrap()
    m._save_checkpoint()
    store.flush()
    MinerLoop(eng, InMemoryTransport(), "hotkey_1",
              checkpoint_store=store).bootstrap(params=thunk)
    assert not calls


@pytest.mark.parametrize("role", ["miner", "validator", "averager",
                                  "server"])
def test_config_takes_init_from_and_scan_blocks(role):
    """``--init-from`` and ``--scan-blocks`` pass ``check_ported`` on
    every role, beside ``--obs-port``, ``--chaos-spec`` and
    ``--compile-cache-dir`` (ported since); the refusals that stand still
    raise, naming their slice."""
    from distributedtraining_tpu_torch.config import RunConfig
    RunConfig.from_args(role, ["--init-from", "hf:org/name",
                               "--scan-blocks"]).check_ported()
    RunConfig.from_args(role, ["--init-from", "x", "--obs-port", "9100",
                               "--chaos-spec", "{}", "--compile-cache-dir",
                               "d"]).check_ported()
    for extra in (["--backend", "hf"], ["--mlflow-uri", "u"]):
        with pytest.raises(NotImplementedError, match="slice 7"):
            RunConfig.from_args(role, ["--init-from", "x", *extra]
                                ).check_ported()


def test_two_process_miner_cli_init_from_and_scan(tmp_path, tiny_ckpt):
    """Two ranks of the miner CLI at fsdp 2 with ``--init-from`` and
    ``--scan-blocks`` and nothing published: the coordinator converts and
    every rank receives the tree (its shards after bootstrap are the
    stacked checkpoint's slices, bit for bit), the coordinator alone
    publishes, and the pushed delta travels unrolled."""
    from distributedtraining_tpu_torch.delta import flatten_tree
    from distributedtraining_tpu_torch.parallel import sharding as tsh
    from test_torch_parallel import (_delta_on_the_wire, _miner_argv,
                                     _run_world)
    work = tmp_path / "work"
    io = tmp_path / "io"
    io.mkdir()
    outs = _run_world(io, "miner", {"dp": 2}, {}, {
        "argv": _miner_argv(work, ["--max-steps", "2",
                                   "--checkpoint-interval", "0",
                                   "--init-from", tiny_ckpt,
                                   "--scan-blocks"])})
    assert [int(o["rc"]) for o in outs] == [0, 0]
    cfg = dataclasses.replace(tg.PRESETS["tiny"], scan_blocks=True)
    want = {k: np.asarray(v) for k, v in models.stack_blocks(
        cfg, flatten_tree(tconv.load_params(tiny_ckpt, tg.PRESETS["tiny"])))
        .items()}
    assert "h.block.c_attn.kernel" in want
    specs = tsh.param_specs(want)
    shape = {"dp": 1, "fsdp": 2, "sp": 1, "tp": 1}
    for o in outs:
        coords = json.loads(str(o["coords"]))
        for k, v in want.items():
            sl = tsh.shard_slices(k, v.shape, specs[k], shape, coords)
            np.testing.assert_array_equal(o[f"boot/{k}"], v[sl], err_msg=k)
    delta = _delta_on_the_wire(work)
    assert "h_0.c_attn.kernel" in delta and all(
        np.isfinite(np.asarray(d)).all() for d in delta.values())
