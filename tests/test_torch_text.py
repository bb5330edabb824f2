"""Local text in the port (``data/bpe.py``, ``data/datasets.py``'s
``load_tokenizer`` and corpora, ``neurons/common.build_tokenizer``)
against the JAX package, on the CPU.

- The byte-level BPE: ``tokenizer.json`` bytes and ids equal to JAX's at
  vocab 600, from documents and from files (``corpus_files`` equal too);
  ``train_or_load`` prefers the saved file.
- ``text_corpus``: ``files:<glob>`` equal to JAX's for both splits, with
  JAX's errors; ``wikitext`` and ``auto`` equal to JAX's through a faked
  ``datasets.load_dataset``; ``auto`` with no cache is the synthetic
  corpus at once and asks no socket to connect; without ``datasets``,
  ``auto`` is synthetic and ``wikitext`` raises ImportError.
- ``load_tokenizer`` on tiny tokenizers saved with
  ``PreTrainedTokenizerFast.save_pretrained``: ids, ``vocab_size`` and
  ``pad_id`` equal to JAX's; a name in no local cache gives
  ``ByteTokenizer`` on both sides, the port with a warning naming it.
- The tokenizer branch of the build, branch for branch; the miner CLI
  with ``--tokenizer bpe --dataset files:...``: its first batch equal to
  JAX's ``batch_iterator`` over the same files and tokenizer; on a gloo
  world of two processes the coordinator alone trains the BPE.

Documents are drawn from a numpy seed and written to ``tmp_path``.
"""

import dataclasses
import json
import logging
import os
import socket
import sys

import numpy as np
import pytest

pytest.importorskip("tokenizers")

from distributedtraining_tpu.data import bpe as jbpe  # noqa: E402
from distributedtraining_tpu.data import datasets as jds  # noqa: E402
from distributedtraining_tpu_torch.config import RunConfig  # noqa: E402
from distributedtraining_tpu_torch.data import bpe as tbpe  # noqa: E402
from distributedtraining_tpu_torch.data import datasets as tds  # noqa: E402

DOCS = [
    "The quick brown fox jumps over the lazy dog.",
    "Distributed training merges weight deltas from many miners.",
    "A validator scores each delta against the shared base model.",
    "Byte level BPE covers any unicode input via its 256-byte alphabet.",
] * 16
TEXT = "The validator scores weight deltas from the miners, unseen zxqvj."
_WORDS = ("the of and to in is was for on that with as by at from it an be "
          "this are or which their has had were been its not they but one "
          "all can more when time state also two first new only world year "
          "over system model train data loss weight merge chain score miner "
          "validator average delta network shard base round").split()


def _paragraph(rng, n_words):
    return " ".join(_WORDS[i] for i in rng.integers(0, len(_WORDS),
                                                    n_words)) + "."


def _write_docs(root, seed=0, n_files=4, paras=12):
    """Markdown files under ``root``: paragraphs of 20-80 words (most over
    200 chars), short headers between them, one file of headers only."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "sub"), exist_ok=True)
    for f in range(n_files):
        parts = []
        for p in range(paras):
            parts.append(f"# header {f}.{p}")
            parts.append(_paragraph(rng, int(rng.integers(20, 80))))
        where = root if f % 2 else os.path.join(root, "sub")
        with open(os.path.join(where, f"doc{f}.md"), "w") as fh:
            fh.write("\n\n".join(parts))
    with open(os.path.join(root, "short.md"), "w") as fh:
        fh.write("# only\n\nshort lines\n\nhere")
    with open(os.path.join(root, "skip.txt"), "w") as fh:
        fh.write(_paragraph(rng, 60))
    return os.path.join(root, "**", "*.md")


# ---------------------------------------------------------------------------
# The BPE
# ---------------------------------------------------------------------------

def test_bpe_json_bytes_and_ids_equal_jax_from_docs(tmp_path):
    ours = tbpe.BPETokenizer.train(vocab_size=600, docs=DOCS,
                                   save_path=str(tmp_path / "t.json"))
    ref = jbpe.BPETokenizer.train(vocab_size=600, docs=DOCS,
                                  save_path=str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert ours.vocab_size == ref.vocab_size
    assert ours.pad_id == ref.pad_id == 0
    ids = ours.encode(TEXT)
    assert ids == ref.encode(TEXT) and 0 not in ids
    assert ours.decode(ids) == ref.decode(ids) == TEXT
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_bpe_json_bytes_equal_jax_from_files(tmp_path):
    """``corpus_files`` over a glob (sorted, suffixes skipped, the byte
    cap) and training on those files: equal to JAX's."""
    pattern = _write_docs(str(tmp_path / "docs"))
    (tmp_path / "docs" / "image.png").write_bytes(b"\x89PNG")
    globs = (pattern, str(tmp_path / "docs" / "*"))
    files = tbpe.corpus_files(globs)
    assert files == jbpe.corpus_files(globs)
    assert not any(f.endswith(".png") for f in files)
    cap = os.path.getsize(files[0]) + os.path.getsize(files[1])
    assert tbpe.corpus_files(globs, max_bytes=cap) == \
        jbpe.corpus_files(globs, max_bytes=cap) == files[:2]
    tbpe.BPETokenizer.train(vocab_size=600, files=files,
                            save_path=str(tmp_path / "t.json"))
    jbpe.BPETokenizer.train(vocab_size=600, files=files,
                            save_path=str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    with pytest.raises(FileNotFoundError, match="no corpus files"):
        tbpe.BPETokenizer.train(vocab_size=600, files=[])


def test_bpe_train_or_load_prefers_the_saved_file(tmp_path):
    path = str(tmp_path / "tok" / "bpe.json")
    saved = tbpe.BPETokenizer.train(vocab_size=600, docs=DOCS,
                                    save_path=path)
    mtime = os.stat(path).st_mtime_ns
    # a different vocab asked: the saved file wins, untouched, as in JAX
    ours = tbpe.BPETokenizer.train_or_load(path, vocab_size=300)
    ref = jbpe.BPETokenizer.train_or_load(path, vocab_size=300)
    assert ours.vocab_size == ref.vocab_size == saved.vocab_size
    assert ours.encode(TEXT) == ref.encode(TEXT) == saved.encode(TEXT)
    assert os.stat(path).st_mtime_ns == mtime


# ---------------------------------------------------------------------------
# The corpora
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("n_docs", [256, 7])
def test_files_corpus_equals_jax(tmp_path, split, n_docs):
    pattern = _write_docs(str(tmp_path / "docs"))
    ours = tds.text_corpus(split=split, n_docs=n_docs,
                           source=f"files:{pattern}")
    ref = jds.text_corpus(split=split, n_docs=n_docs,
                          source=f"files:{pattern}")
    assert ours == ref and ours
    assert all(len(d) >= 200 for d in ours)


def test_files_corpus_splits_are_disjoint(tmp_path):
    pattern = _write_docs(str(tmp_path / "docs"))
    train = tds.text_corpus(split="train", source=f"files:{pattern}")
    test = tds.text_corpus(split="test", source=f"files:{pattern}")
    assert test and not set(train) & set(test)


def test_files_corpus_errors_equal_jax(tmp_path):
    none = f"files:{tmp_path}/nothing/**/*.md"
    for mod in (tds, jds):
        with pytest.raises(FileNotFoundError, match="nothing matches"):
            mod.text_corpus(source=none)
    (tmp_path / "a.md").write_text("# title\n\nshort\n\n" + "x" * 199)
    for mod in (tds, jds):
        with pytest.raises(ValueError, match=">=200-char paragraphs"):
            mod.text_corpus(source=f"files:{tmp_path}/*.md")


_WIKI = {"train": ["", " = Valkyria Chronicles = ", "  ",
                   "Senjou no Valkyria is a tactical role playing game.",
                   "", "It was released in 2011 .", "\n", "The end ."] * 3,
         "test": ["", " = Robert Boulter = ", "He is an actor .", ""]}


@pytest.fixture
def fake_wikitext(monkeypatch):
    """``datasets.load_dataset`` faked for both packages: the wikitext
    lines of each split, the calls recorded."""
    datasets = pytest.importorskip("datasets")
    calls = []

    def load_dataset(path, name=None, split=None, download_mode=None):
        calls.append((path, name, split, str(download_mode)))
        return {"text": list(_WIKI[split])}

    monkeypatch.setattr(datasets, "load_dataset", load_dataset)
    return calls


@pytest.mark.parametrize("source", ["wikitext", "auto"])
@pytest.mark.parametrize("split,n_docs", [("train", 256), ("train", 3),
                                          ("test", 256)])
def test_wikitext_and_auto_equal_jax(fake_wikitext, source, split, n_docs):
    ours = tds.text_corpus(split=split, n_docs=n_docs, source=source)
    ref = jds.text_corpus(split=split, n_docs=n_docs, source=source)
    assert ours == ref and ours
    assert fake_wikitext[0] == fake_wikitext[1] == (
        "wikitext", "wikitext-103-v1", split, "reuse_cache_if_exists")


def test_wikitext_failure_equals_jax(monkeypatch):
    datasets = pytest.importorskip("datasets")

    def load_dataset(*a, **kw):
        raise FileNotFoundError("wikitext is not cached")

    monkeypatch.setattr(datasets, "load_dataset", load_dataset)
    for mod in (tds, jds):
        with pytest.raises(FileNotFoundError, match="not cached"):
            mod.text_corpus(source="wikitext")
    assert tds.text_corpus(source="auto", n_docs=16) == \
        jds.text_corpus(source="auto", n_docs=16) == \
        tds.text_corpus(source="synthetic", n_docs=16)


@pytest.fixture
def no_network(monkeypatch):
    """Every socket's connect raises, and is counted."""
    attempts = []

    def refuse(self, address, *a):
        attempts.append(address)
        raise OSError("network disabled in this test")

    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket.socket, "connect_ex", refuse)
    return attempts


def test_auto_without_a_cache_is_synthetic_and_asks_no_host(
        tmp_path, monkeypatch, no_network):
    datasets = pytest.importorskip("datasets")
    import datasets.config
    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE",
                        str(tmp_path / "empty_cache"))
    monkeypatch.delenv("HF_HUB_OFFLINE", raising=False)
    monkeypatch.delenv("HF_DATASETS_OFFLINE", raising=False)
    got = tds.text_corpus(source="auto", n_docs=32, seed=4)
    assert got == jds.text_corpus(source="synthetic", n_docs=32, seed=4)
    with pytest.raises(ConnectionError, match="wikitext"):
        tds.text_corpus(source="wikitext")
    assert no_network == []
    # the offline switches are the caller's again
    assert "HF_HUB_OFFLINE" not in os.environ
    assert datasets.config.HF_HUB_OFFLINE is False


def test_without_datasets_auto_is_synthetic_and_wikitext_raises(
        monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    assert tds.text_corpus(source="auto", n_docs=8) == \
        jds.text_corpus(source="synthetic", n_docs=8)
    with pytest.raises(ImportError):
        tds.text_corpus(source="wikitext")


# ---------------------------------------------------------------------------
# HF tokenizers from local files
# ---------------------------------------------------------------------------

def _hf_dir(path, pad_token):
    transformers = pytest.importorskip("transformers")
    tok = tbpe.BPETokenizer.train(vocab_size=300, docs=DOCS)._tok
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok)
    if pad_token is not None:
        fast.add_special_tokens({"pad_token": pad_token})
    fast.save_pretrained(str(path))
    return str(path)


@pytest.mark.parametrize("pad_token", [None, "<|pad|>", "[PAD]"])
def test_load_tokenizer_from_a_local_dir_equals_jax(tmp_path, pad_token,
                                                    no_network):
    d = _hf_dir(tmp_path / "tok", pad_token)
    ours, ref = tds.load_tokenizer(d), jds.load_tokenizer(d)
    assert not isinstance(ours, tds.ByteTokenizer)
    assert ours.vocab_size == ref.vocab_size
    assert ours.pad_id == ref.pad_id
    assert ours.encode(TEXT) == ref.encode(TEXT)
    ids = ours.encode(TEXT)
    assert ours.decode(ids) == ref.decode(ids)
    assert (ours.pad_id == 0) == (pad_token in (None, "<|pad|>"))
    assert no_network == []


def test_load_tokenizer_of_an_uncached_name_is_bytes(tmp_path, monkeypatch,
                                                     no_network, caplog):
    pytest.importorskip("transformers")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    name = "no-such-org/no-such-tokenizer"
    with caplog.at_level(logging.WARNING):
        ours = tds.load_tokenizer(name)
    assert isinstance(ours, tds.ByteTokenizer)
    assert isinstance(jds.load_tokenizer(name), jds.ByteTokenizer)
    assert any(name in r.getMessage() and "ByteTokenizer" in r.getMessage()
               for r in caplog.records)
    assert no_network == []


# ---------------------------------------------------------------------------
# The build's tokenizer branch and the miner CLI
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ModelCfg:
    vocab_size: int


def test_build_tokenizer_branches_like_jax(tmp_path, monkeypatch,
                                           no_network):
    from distributedtraining_tpu_torch.neurons.common import build_tokenizer
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    work = str(tmp_path / "w")

    def cfg(*argv):
        return RunConfig.from_args("miner", ["--work-dir", work,
                                             "--dataset", "synthetic",
                                             *argv])

    # byte, and auto under GPT-2's vocabulary
    for argv, vocab in ((["--tokenizer", "byte"], 50257),
                        (["--tokenizer", "auto"], 50256)):
        assert isinstance(build_tokenizer(cfg(*argv), _ModelCfg(vocab)),
                          tds.ByteTokenizer)
    # word: the corpus-fit vocabulary
    w = build_tokenizer(cfg("--tokenizer", "word"), _ModelCfg(512))
    assert isinstance(w, tds.WordTokenizer) and w.vocab_size == 512
    # auto at GPT-2's vocabulary: "gpt2" from the local cache, here none
    auto = build_tokenizer(cfg("--tokenizer", "auto"), _ModelCfg(50257))
    assert isinstance(auto, tds.ByteTokenizer)
    # a local HF directory by name
    d = _hf_dir(tmp_path / "hf", "[PAD]")
    hf = build_tokenizer(cfg("--tokenizer", d), _ModelCfg(50257))
    assert hf.encode(TEXT) == jds.load_tokenizer(d).encode(TEXT)
    # bpe: min(vocab, 32000), saved under the work dir (placed here, so
    # that nothing trains on the machine's own text)
    for vocab, name in ((50257, "bpe-32000.json"), (512, "bpe-512.json")):
        path = os.path.join(work, "tokenizer", name)
        jbpe.BPETokenizer.train(vocab_size=600, docs=DOCS, save_path=path)
        bpe = build_tokenizer(cfg("--tokenizer", "bpe"), _ModelCfg(vocab))
        assert isinstance(bpe, tbpe.BPETokenizer)
        assert bpe.encode(TEXT) == jbpe.BPETokenizer.load(path).encode(TEXT)
    assert no_network == []


def test_miner_cli_bpe_files_first_batch_equals_jax(tmp_path, monkeypatch):
    """The port's miner CLI with ``--tokenizer bpe --dataset
    files:<glob>`` (the BPE file in the work dir, trained by the JAX
    package on the same files): its first batch equals JAX's
    ``batch_iterator`` over the same corpus and tokenizer, at the
    miner's shuffle seed."""
    import torch

    from distributedtraining_tpu_torch.engine import train as ttrain
    from distributedtraining_tpu_torch.models import gpt2 as tg
    from distributedtraining_tpu_torch.neurons import miner as tminer
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    pattern = _write_docs(str(tmp_path / "docs"), seed=3, paras=16)
    work = tmp_path / "run"
    vocab = tg.make_model("tiny")[1].vocab_size
    tok_path = work / "tokenizer" / f"bpe-{min(vocab, 32000)}.json"
    jbpe.BPETokenizer.train(vocab_size=min(vocab, 32000),
                            files=jbpe.corpus_files((pattern,)),
                            save_path=str(tok_path))
    seen = []
    real = ttrain.MinerLoop._train_one

    def spy(self, batch):
        seen.append({k: np.array(v) for k, v in batch.items()})
        return real(self, batch)

    monkeypatch.setattr(ttrain.MinerLoop, "_train_one", spy)
    B, T = 2, 32
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert tminer.main([
            "--work-dir", str(work), "--backend", "local", "--model", "tiny",
            "--tokenizer", "bpe", "--dataset", f"files:{pattern}",
            "--batch-size", str(B), "--seq-len", str(T), "--max-steps", "2",
            "--no-base-wire-v2", "--checkpoint-interval", "0",
            "--no-anomaly-trace", "--flight-events", "0",
            "--eval-batches", "1"]) == 0
    finally:
        root.handlers[:], root.level = handlers, level
        torch.set_num_threads(threads)
    jtok = jbpe.BPETokenizer.load(str(tok_path))
    want = next(jds.batch_iterator(
        jds.text_corpus(split="train", source=f"files:{pattern}",
                        n_docs=256), jtok, batch_size=B, seq_len=T,
        repeat=True, max_vocab=vocab, shuffle=True,
        seed=jds.shuffle_seed_for("hotkey_0")))
    assert len(seen) == 2
    assert seen[0].keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(seen[0][k], want[k], err_msg=k)
    ids = seen[0]["input_ids"]
    assert ids.max() < jtok.vocab_size and ids.max() > 257


def test_two_process_world_trains_the_bpe_once(tmp_path):
    """A gloo world of two miner processes with ``--tokenizer bpe`` and
    no saved file: the coordinator trains and saves it, the other rank
    waits and loads it; both encode alike, the file JAX's bytes."""
    from test_torch_parallel import _run_world
    pattern = _write_docs(str(tmp_path / "docs"), seed=5)
    work = tmp_path / "work"
    io = tmp_path / "io"
    io.mkdir()
    outs = _run_world(io, "bpe_build", {"dp": 2}, {}, {
        "argv": ["--work-dir", str(work), "--model", "tiny",
                 "--tokenizer", "bpe", "--dataset", f"files:{pattern}",
                 "--backend", "memory", "--flight-events", "0",
                 "--dp", "0", "--fsdp", "2"],
        "corpus": pattern, "text": TEXT})
    assert [int(o["trains"]) for o in outs] == [1, 0]
    assert [int(o["loads"]) for o in outs] == [0, 1]
    ids = [json.loads(str(o["ids"])) for o in outs]
    assert ids[0] == ids[1]
    path = work / "tokenizer" / "bpe-512.json"
    jbpe.BPETokenizer.train(vocab_size=512,
                            files=jbpe.corpus_files((pattern,)),
                            save_path=str(tmp_path / "j.json"))
    assert path.read_bytes() == (tmp_path / "j.json").read_bytes()
    assert ids[0] == jbpe.BPETokenizer.load(str(path)).encode(TEXT)
