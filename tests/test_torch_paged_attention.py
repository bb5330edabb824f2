"""Paged-attention decode in the PyTorch port (distributedtraining_tpu_torch
/ops/paged_attention.py) against the JAX package.

On the CPU the port dispatches to its plain version, which must match the
JAX package's ``paged_decode_reference`` at every shape class the serving
engine produces (the shape classes of tests/test_paged_attention.py),
f32, to 1e-6. The plain version of the kernel's split decomposition
(partials per chunk of context, then the merge) is held against both
references and against the JAX package's Pallas kernel run interpreted,
at those shapes and at the split boundaries; the host planner of the
split is checked on its own. The CUDA kernel itself is held against the
plain versions on the card by chip_smoke.py.
"""

import inspect

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributedtraining_tpu.ops import paged_attention as jpa
from distributedtraining_tpu_torch.ops import paged_attention as tpa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers beside timing-sensitive JAX
    tests; these tiny shapes need no intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name -> (B, Hq, Hkv, D, P, MP, seq_lens)
CASES = {
    "gqa_ragged": (3, 8, 2, 64, 8, 4, [13, 27, 5]),
    "mha": (2, 4, 4, 32, 8, 4, [30, 2]),
    "page_boundary_lengths": (4, 4, 2, 64, 8, 4, [0, 8, 16, 31]),
    "multi_chunk": (2, 4, 2, 64, 8, 16, [127, 64]),
}


# the split boundaries at chunk C = 16 (P 8, MP 8: a 64-position table):
# contexts 0, C - 1, C, C + 1 and MP * P, for G 1, 4, 8 and D 64, 128
SPLIT_CHUNK = 16
SPLIT_CASES = {f"split_g{G}_d{D}": (5, 2 * G, 2, D, 8, 8, [0, 15, 16, 17, 64])
               for G in (1, 4, 8) for D in (64, 128)}
# the planner's own chunk (64) over a 128-position table
SPLIT_CASES["planner_chunk"] = (5, 8, 2, 64, 8, 16, [0, 63, 64, 65, 128])
ALL_CASES = {**CASES, **SPLIT_CASES}


def _chunk(name):
    return SPLIT_CHUNK if name.startswith("split_") else None


def _case(B, Hq, Hkv, D, P, MP, lens, *, seed=0):
    rng = np.random.default_rng(seed)
    pool = 1 + B * MP
    f32 = np.float32
    return (rng.standard_normal((B, 1, Hq, D)).astype(f32),
            rng.standard_normal((pool, P, Hkv, D)).astype(f32),
            rng.standard_normal((pool, P, Hkv, D)).astype(f32),
            rng.integers(1, pool, (B, MP)).astype(np.int32),
            np.asarray(lens, np.int32),
            rng.standard_normal((B, 1, Hkv, D)).astype(f32),
            rng.standard_normal((B, 1, Hkv, D)).astype(f32))


def _both(args):
    ours = tpa.paged_attention(*(torch.from_numpy(a) for a in args))
    # jitted: one XLA compile instead of one per eager op
    ref = jax.jit(jpa.paged_decode_reference)(*(jnp.asarray(a)
                                                for a in args))
    return ours.numpy(), np.asarray(ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_reference(name):
    ours, ref = _both(_case(*CASES[name]))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def _split(args, name):
    return tpa.paged_decode_split_reference(
        *(torch.from_numpy(a) for a in args), chunk=_chunk(name)).numpy()


@pytest.mark.parametrize("name", sorted(ALL_CASES))
def test_split_plain_version_matches_both_references(name):
    """The kernel's decomposition (partials per chunk, then the merge
    with the fresh column) against the port's plain version and the JAX
    package's reference, f32, 1e-6."""
    args = _case(*ALL_CASES[name])
    split = _split(args, name)
    ours, ref = _both(args)
    assert split.shape == ref.shape and split.dtype == np.float32
    np.testing.assert_allclose(split, ours, rtol=0, atol=1e-6)
    np.testing.assert_allclose(split, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(ALL_CASES))
def test_split_plain_version_matches_interpreted_pallas_kernel(
        name, monkeypatch):
    """The JAX package's Pallas kernel, run in interpret mode on the CPU,
    as the oracle of the split. jax 0.9 names the compiler parameters
    ``CompilerParams``; the kernel asks for the older
    ``TPUCompilerParams``, so this test aliases the name for its own
    duration (no JAX file changes)."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    args = _case(*ALL_CASES[name])
    kernel = jpa.paged_decode_attention(*(jnp.asarray(a) for a in args),
                                        interpret=True)
    assert kernel is not None, "the interpreted kernel declined"
    np.testing.assert_allclose(_split(args, name), np.asarray(kernel),
                               rtol=0, atol=1e-6)


def test_split_plain_version_never_reads_past_the_context():
    """Rows at or past a slot's context take no part: NaN there (in the
    trash page and past seq_len in real pages) leaves the output equal to
    the one from clean pools."""
    args = _case(*SPLIT_CASES["split_g4_d64"])
    q, kp, vp, pt, sl, kn, vn = args
    # distinct pages per entry (the engine's layout), so that poisoning
    # one slot's rows touches no other slot's context
    pt = (np.random.default_rng(1).permutation(pt.size) + 1).reshape(
        pt.shape).astype(np.int32)
    P = kp.shape[1]
    for b, n in enumerate(sl):
        pt[b, -(-int(n) // P):] = 0          # padded entries: trash page
    clean = _split((q, kp, vp, pt, sl, kn, vn), "split_g4_d64")
    kp, vp = kp.copy(), vp.copy()
    kp[0] = vp[0] = np.nan
    for b, n in enumerate(sl):
        if n % P:                            # the rest of a partial page
            kp[pt[b, n // P], n % P:] = vp[pt[b, n // P], n % P:] = np.nan
    poisoned = _split((q, kp, vp, pt, sl, kn, vn), "split_g4_d64")
    assert np.isfinite(poisoned).all()
    np.testing.assert_array_equal(poisoned, clean)


@pytest.mark.parametrize("MP,P", [(1, 1), (4, 8), (8, 8), (16, 8),
                                  (64, 16), (256, 16), (3, 48), (2, 100),
                                  (7, 5)])
def test_planner_covers_the_table_in_whole_pages(MP, P):
    """The splits cover exactly [0, MP * P), once each; a chunk is whole
    pages; and the planner sees shapes only: it has no ``seq_lens``
    argument, so the wrapper reads nothing back from the card."""
    assert list(inspect.signature(tpa.plan_split).parameters) == [
        "max_pages", "page_size", "batch", "n_kv_heads"]
    plan = tpa.plan_split(MP, P, 3, 2)
    width, C = MP * P, plan.chunk
    assert C % P == 0 and C >= min(64, width)
    covered = [t for s in range(plan.splits)
               for t in range(s * C, min(s * C + C, width))]
    assert covered == list(range(width))
    assert (plan.splits - 1) * C < width
    assert plan.blocks == 3 * 2 * plan.splits
    # planned once per shape: a decode step asks once a layer
    assert tpa.plan_split(MP, P, 3, 2) is plan


def test_trash_page_zero_lanes():
    """Padded lanes: table all zeros (trash page), seq_len 0. The output
    is attention over only the fresh column, i.e. exactly v_new per
    head; a poisoned trash page must not leak."""
    q, kp, vp, pt, sl, kn, vn = _case(2, 4, 2, 64, 8, 4, [0, 0])
    kp[0] = 1e3
    vp[0] = 1e3
    pt[:] = 0
    ours, ref = _both((q, kp, vp, pt, sl, kn, vn))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours, np.repeat(vn, 2, axis=2), atol=1e-6)


def test_cpu_dispatch_runs_the_plain_version_and_counts_no_launch():
    args = [torch.from_numpy(a) for a in _case(*CASES["gqa_ragged"])]
    before = tpa.launches
    out = tpa.paged_attention(*args)
    assert torch.equal(out, tpa.paged_decode_reference(*args))
    assert tpa.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches on CUDA tensors or raises; it never
    computes on the CPU itself."""
    args = [torch.from_numpy(a) for a in _case(*CASES["mha"])]
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_attention(*args)


def test_import_builds_nothing_and_needs_no_nvcc():
    """Importing the module (and the model that uses it) neither finds
    nvcc nor builds or loads a kernel library."""
    code = ("import distributedtraining_tpu_torch.models.gpt2, "
            "distributedtraining_tpu_torch.ops.paged_attention as pa\n"
            "from distributedtraining_tpu_torch.ops import _cuda\n"
            "assert not _cuda._LIBS, _cuda._LIBS\n"
            "print('ok')\n")
    env = {"PATH": "/nonexistent", "PYTHONPATH": REPO,
           "HOME": os.environ.get("HOME", "/tmp")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
