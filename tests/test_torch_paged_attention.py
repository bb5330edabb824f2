"""Paged-attention decode in the PyTorch port (distributedtraining_tpu_torch
/ops/paged_attention.py) against the JAX package.

On the CPU the port dispatches to its plain version, which must match the
JAX package's ``paged_decode_reference`` at every shape class the serving
engine produces (the shape classes of tests/test_paged_attention.py),
f32, to 1e-6. The CUDA kernel itself is held against the plain version on
the card by chip_smoke.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
