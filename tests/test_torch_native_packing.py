"""The port's C++ packer (``native/packing.cpp`` through
``data/packing._pack_documents_native``) and its build directory
(``ops/_cuda.set_build_dir``, ``--compile-cache-dir``), on the CPU.

- Rows of the C++ packer equal the port's Python loop (its plain
  version) and the JAX package's ``pack_documents(native=False)`` for
  every field, bit for bit: seq_len 16/64 x drop True/False, chunked
  streaming with a small chunk budget, empty and degenerate inputs.
- No silent fallback: where no compiler can be found or the compiler
  fails, the loader and the packer raise with the reason.
- ``--compile-cache-dir``: a build that finds its library runs no
  compiler; two miner CLI runs on one directory, the second building
  nothing (the library's mtime and the compile count unchanged).
- The flag's parity with the JAX parser, and ``check_ported`` taking it
  on every role while its other refusals stand.

Documents are drawn from numpy seeds; the packer is built with the
host's ``g++``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from distributedtraining_tpu.config import RunConfig as JRunConfig
from distributedtraining_tpu.data import packing as jpacking
from distributedtraining_tpu_torch import native
from distributedtraining_tpu_torch.config import RunConfig
from distributedtraining_tpu_torch.data import packing
from distributedtraining_tpu_torch.ops import _cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _collect(it):
    rows = list(it)
    if not rows:
        return None
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _random_docs(rng, n_docs, max_len):
    return [list(rng.integers(1, 1000, rng.integers(0, max_len + 1)))
            for _ in range(n_docs)]


def _assert_rows_equal(want, got):
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


@pytest.fixture
def build_dir(tmp_path):
    """A fresh build directory for the test; the package's own after."""
    prev = _cuda.BUILD_DIR
    _cuda.set_build_dir(tmp_path / "build")
    yield _cuda.BUILD_DIR
    _cuda.BUILD_DIR = prev


@pytest.mark.parametrize("seq_len,drop", [(16, True), (16, False),
                                          (64, True), (64, False)])
def test_native_rows_equal_python_and_jax(seq_len, drop):
    rng = np.random.default_rng(0)
    docs = _random_docs(rng, 200, 3 * seq_len)   # empty and long docs
    got = _collect(packing.pack_documents(docs, seq_len,
                                          drop_remainder=drop))
    plain = _collect(packing.pack_documents(docs, seq_len,
                                            drop_remainder=drop,
                                            native=False))
    ref = _collect(jpacking.pack_documents(docs, seq_len,
                                           drop_remainder=drop,
                                           native=False))
    _assert_rows_equal(plain, got)
    _assert_rows_equal(ref, got)


def test_native_chunked_streaming_equals_python_and_jax():
    """A 64-token chunk budget: many C++ calls with carried-over
    tails."""
    rng = np.random.default_rng(1)
    seq_len = 32
    docs = _random_docs(rng, 300, 2 * seq_len)
    got = _collect(packing._pack_documents_native(
        iter(docs), seq_len, drop_remainder=False, chunk_tokens=64))
    plain = _collect(packing.pack_documents(docs, seq_len,
                                            drop_remainder=False,
                                            native=False))
    ref = _collect(jpacking._pack_documents_native(
        iter(docs), seq_len, drop_remainder=False, chunk_tokens=64)
        if jpacking._native_pack() is not None else
        jpacking.pack_documents(docs, seq_len, drop_remainder=False,
                                native=False))
    _assert_rows_equal(plain, got)
    _assert_rows_equal(ref, got)


@pytest.mark.parametrize("case", ["none", "empty_docs", "one_row",
                                  "seq_len_1", "partial_tail"])
def test_native_empty_and_degenerate(case):
    docs, seq_len, drop = {
        "none": ([], 16, True),
        "empty_docs": ([[], [], []], 16, False),
        "one_row": ([list(range(1, 17))], 16, True),
        "seq_len_1": ([[5, 6, 7], [], [8]], 1, False),
        "partial_tail": ([[1, 2, 3], [4, 5]], 16, False),
    }[case]
    got = _collect(packing.pack_documents(docs, seq_len,
                                          drop_remainder=drop))
    plain = _collect(packing.pack_documents(docs, seq_len,
                                            drop_remainder=drop,
                                            native=False))
    ref = _collect(jpacking.pack_documents(docs, seq_len,
                                           drop_remainder=drop,
                                           native=False))
    if case in ("none", "empty_docs"):
        assert got is None and plain is None and ref is None
        return
    _assert_rows_equal(plain, got)
    _assert_rows_equal(ref, got)


def test_native_rows_are_copies():
    """Each row owns its memory: a kept row does not pin the chunk's
    buffer."""
    rows = list(packing.pack_documents([list(range(1, 40))], 8))
    assert len(rows) == 4
    for r in rows:
        for k, v in r.items():
            assert v.base is None and v.flags.owndata, k


def test_batch_iterator_takes_the_native_packer(monkeypatch):
    from distributedtraining_tpu_torch.data import datasets as tds
    calls = []
    real = packing._pack_documents_native

    def spy(*a, **kw):
        calls.append(1)
        yield from real(*a, **kw)

    monkeypatch.setattr(packing, "_pack_documents_native", spy)
    docs = tds.text_corpus(n_docs=8, seed=0)
    tok = tds.ByteTokenizer()
    got = list(tds.batch_iterator(docs, tok, batch_size=2, seq_len=32))
    assert calls and got


def test_loader_raises_without_a_compiler(build_dir, monkeypatch):
    """No g++ and no nvcc: the loader and the packer raise; nothing
    falls back to the Python loop."""
    monkeypatch.setattr(native.shutil, "which", lambda _name: None)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_cuda, "nvcc_path", no_nvcc)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.load("packing")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        list(packing.pack_documents([[1, 2, 3]], 4))
    assert not list(build_dir.glob("libpacking*"))


def test_loader_raises_with_the_compilers_output(build_dir, monkeypatch):
    monkeypatch.setattr(native, "HOST_FLAGS",
                        (*native.HOST_FLAGS, "-fno-such-flag-anywhere"))
    with pytest.raises(RuntimeError, match="no-such-flag-anywhere"):
        native.load("packing")
    assert not [p for p in build_dir.iterdir() if p.suffix == ".so"]


def test_a_built_library_runs_no_compiler(build_dir):
    """The first build compiles into the directory; a second finds it,
    returns 0.0 and runs nothing; the library path is keyed by source,
    compiler and flags."""
    before = _cuda.compiles
    assert native.build("packing") > 0.0
    assert _cuda.compiles == before + 1
    lib = native.library_path("packing")
    assert lib.parent == build_dir and lib.exists()
    mtime = lib.stat().st_mtime_ns
    assert native.build("packing") == 0.0
    assert _cuda.compiles == before + 1
    assert lib.stat().st_mtime_ns == mtime
    rows = _collect(packing.pack_documents([[1, 2, 3, 4, 5]], 4,
                                           drop_remainder=False))
    assert rows["input_ids"].tolist() == [[1, 2, 3, 4], [5, 0, 0, 0]]
    assert _cuda.compiles == before + 1
    assert native.library_path("packing", "nvcc") != lib


_CLI = """
import json, sys
from distributedtraining_tpu_torch.neurons import miner
from distributedtraining_tpu_torch.ops import _cuda
rc = miner.main(sys.argv[1:])
print("RESULT " + json.dumps({"rc": rc, "compiles": _cuda.compiles,
                              "build_dir": str(_cuda.BUILD_DIR)}))
"""


def _miner_cli(work, cache):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["DT_FORCE_PLATFORM"] = "cpu"
    env["PYTHONPATH"] = REPO
    argv = ["--work-dir", str(work), "--backend", "local", "--model",
            "tiny", "--dataset", "synthetic", "--tokenizer", "word",
            "--batch-size", "2", "--seq-len", "32", "--max-steps", "2",
            "--no-base-wire-v2", "--checkpoint-interval", "0",
            "--flight-events", "0", "--no-anomaly-trace",
            "--compile-cache-dir", str(cache)]
    proc = subprocess.run([sys.executable, "-c", _CLI, *argv], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_compile_cache_dir_second_run_builds_nothing(tmp_path):
    """Two miner CLI processes with one ``--compile-cache-dir``: the
    first builds the packer there (one compiler run), the second loads
    it (none), and the library is the same file, untouched."""
    cache = tmp_path / "cache"
    first = _miner_cli(tmp_path / "w1", cache)
    assert first["rc"] == 0 and first["compiles"] == 1
    assert first["build_dir"] == str(cache)
    libs = sorted(cache.glob("libpacking-*.so"))
    assert len(libs) == 1
    mtime = libs[0].stat().st_mtime_ns
    second = _miner_cli(tmp_path / "w2", cache)
    assert second["rc"] == 0 and second["compiles"] == 0
    assert sorted(cache.glob("libpacking-*.so")) == libs
    assert libs[0].stat().st_mtime_ns == mtime


@pytest.mark.parametrize("role", ["miner", "validator", "averager",
                                  "server"])
def test_config_takes_compile_cache_dir_like_jax(role):
    """The flag parses as the JAX parser parses it and passes
    ``check_ported``; the refusals that stand keep their messages."""
    for argv in (["--compile-cache-dir", "/tmp/cc"], []):
        ours = dataclasses.asdict(RunConfig.from_args(role, argv))
        ref = dataclasses.asdict(JRunConfig.from_args(role, argv))
        assert ours["compile_cache_dir"] == ref["compile_cache_dir"]
        assert {k: v for k, v in ours.items() if k != "mesh"} == {
            k: ref[k] for k in ours if k != "mesh"}
    RunConfig.from_args(role, ["--compile-cache-dir", "d"]).check_ported()
    for extra, what in ((["--backend", "hf"], "--backend hf"),
                        (["--mlflow-uri", "u"], "--mlflow-uri")):
        with pytest.raises(NotImplementedError, match="slice 7") as e:
            RunConfig.from_args(role, ["--compile-cache-dir", "d", *extra]
                                ).check_ported()
        assert str(e.value).startswith(what)


def test_role_build_sets_the_build_dir(tmp_path, monkeypatch):
    """``build`` points the kernels' and the packer's build directory at
    ``--compile-cache-dir`` and creates it."""
    from distributedtraining_tpu_torch.neurons import common
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    monkeypatch.setattr(_cuda, "BUILD_DIR", _cuda.BUILD_DIR)
    cache = tmp_path / "cc"
    cfg = RunConfig.from_args("miner", [
        "--work-dir", str(tmp_path / "w"), "--backend", "memory",
        "--model", "tiny", "--dataset", "synthetic", "--tokenizer", "byte",
        "--flight-events", "0", "--compile-cache-dir", str(cache)])
    common.build(cfg)
    assert _cuda.BUILD_DIR == cache and cache.is_dir()
    assert native.library_path("packing").parent == cache
    assert _cuda.library_path("fused_ce").parent == cache
