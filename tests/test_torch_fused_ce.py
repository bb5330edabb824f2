"""The fused linear cross-entropy of the PyTorch port
(distributedtraining_tpu_torch/ops/fused_ce.py and
ops/losses.fused_linear_cross_entropy) against the JAX package's
``fused_linear_cross_entropy``, on the CPU.

The port's CPU path is the plain version of its three CUDA kernels (the
forward, dh and dW); the oracles are the JAX package's Pallas kernels run
in interpret mode (``impl="pallas", interpret=True``) and its lax.scan
spelling (``impl="scan"``). Inputs come from numpy with a seed. Limits
are the JAX package's own (tests/test_fused_loss.py): f32 value rtol
1e-5, grads rtol 2e-4 / atol 1e-6; bf16 hidden against the f32 head, dW
(f32) rtol 2e-2 / atol 2e-4 and dh (bf16) rtol 5e-2 / atol 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu.ops.losses import fused_linear_cross_entropy \
    as jax_fused
from distributedtraining_tpu_torch.ops import fused_ce as tfce
from distributedtraining_tpu_torch.ops import losses as tlosses


def _case(V=300, E=64, N=24, seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((N, E)).astype(np.float32)
    wte = (rng.standard_normal((V, E)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (N,)).astype(np.int32)
    mask = (rng.random(N) > 0.3).astype(np.float32)
    return hidden, wte, labels, mask


def _port(hidden, wte, labels, mask, dtype=torch.float32):
    """(loss, count, dhidden, dwte) of the port, on the CPU."""
    h = torch.from_numpy(hidden).to(dtype).requires_grad_()
    w = torch.from_numpy(wte).requires_grad_()
    loss, count = tlosses.fused_linear_cross_entropy(
        h[None], w, torch.from_numpy(labels)[None],
        None if mask is None else torch.from_numpy(mask)[None])
    loss.backward()
    return loss.detach(), count, h.grad, w.grad


_JAX_GRADS = {}


def _jax(hidden, wte, labels, mask, impl, dtype=jnp.float32):
    """(loss, count, dhidden, dwte) of the JAX package (one jitted
    program per impl and dtype, shared by the cases)."""
    key = (impl, dtype, mask is None)
    if key not in _JAX_GRADS:
        kw = {"interpret": True} if impl == "pallas" else {}

        def f(h, w, y, m):
            loss, count = jax_fused(h[None], w, y[None],
                                    None if m is None else m[None],
                                    impl=impl, **kw)
            return loss, count

        _JAX_GRADS[key] = jax.jit(jax.value_and_grad(f, argnums=(0, 1),
                                                     has_aux=True))
    (loss, count), (dh, dw) = _JAX_GRADS[key](
        jnp.asarray(hidden, dtype), jnp.asarray(wte), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    return loss, count, dh, dw


@pytest.mark.parametrize("impl", ["pallas", "scan"])
def test_value_and_grads_match_jax_f32(impl):
    """V 300 (not a multiple of any tile), E 64, N 24, with a mask."""
    hidden, wte, labels, mask = _case()
    loss, count, dh, dw = _port(hidden, wte, labels, mask)
    jl, jc, jdh, jdw = _jax(hidden, wte, labels, mask, impl)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(count) == float(jc) == float(mask.sum())
    for name, a, b in (("dhidden", dh, jdh), ("dwte", dw, jdw)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("impl", ["pallas", "scan"])
def test_bf16_hidden_f32_head_matches_jax(impl):
    """The training dtype mix: bf16 hidden against the f32 tied head. dW
    comes back in f32 to the f32 head, dh in bf16."""
    hidden, wte, labels, _ = _case(V=256, E=64, N=32, seed=1)
    loss, _, dh, dw = _port(hidden, wte, labels, None,
                            dtype=torch.bfloat16)
    jl, _, jdh, jdw = _jax(hidden, wte, labels, None, impl,
                           dtype=jnp.bfloat16)
    assert dh.dtype == torch.bfloat16 and dw.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-2)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=2e-2,
                               atol=2e-4)
    np.testing.assert_allclose(dh.float().numpy(),
                               np.asarray(jdh, np.float32), rtol=5e-2,
                               atol=5e-4)


def test_all_zero_mask_gives_count_one_and_loss_zero():
    hidden, wte, labels, mask = _case(seed=2)
    zeros = np.zeros_like(mask)
    loss, count, dh, dw = _port(hidden, wte, labels, zeros)
    jl, jc, _, _ = _jax(hidden, wte, labels, zeros, "pallas")
    assert float(loss) == float(jl) == 0.0
    assert float(count) == float(jc) == 1.0
    assert not dh.any() and not dw.any()


def test_plain_kernels_match_dense_logits_and_label_in_last_column():
    """The plain forward's (loss, m, s) and the plain backward's (dh, dW)
    against autograd through materialised logits, with labels in the last
    vocab column (where the kernels' ragged last tile is)."""
    hidden, wte, labels, _ = _case(V=200, E=64, N=40, seed=3)
    labels[::4] = 199
    h, w = torch.from_numpy(hidden), torch.from_numpy(wte)
    y = torch.from_numpy(labels)
    loss, m, s = tfce.fused_ce_fwd_reference(h, w, y)
    z = h @ w.T
    np.testing.assert_allclose(m.numpy(), z.amax(-1).numpy(), rtol=0,
                               atol=0)
    ref = torch.logsumexp(z, -1) - z.gather(1, y.long()[:, None])[:, 0]
    np.testing.assert_allclose(loss.numpy(), ref.numpy(), rtol=1e-6)
    g = torch.from_numpy(np.random.default_rng(4).random(40)
                         .astype(np.float32))
    dh, dw = tfce.fused_ce_bwd_reference(h, w, y, m, s, g)
    hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
    zz = hh @ ww.T
    per = torch.logsumexp(zz, -1) - zz.gather(1, y.long()[:, None])[:, 0]
    (per * g).sum().backward()
    np.testing.assert_allclose(dh.numpy(), hh.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), ww.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_cpu_takes_the_plain_versions_and_counts_no_launch():
    hidden, wte, labels, mask = _case(seed=5)
    before = dict(tfce.launches)
    _port(hidden, wte, labels, mask)
    assert tfce.launches == before


def test_kernel_wrappers_refuse_cpu_tensors():
    hidden, wte, labels, _ = _case(seed=6)
    h, w = torch.from_numpy(hidden), torch.from_numpy(wte)
    y = torch.from_numpy(labels)
    with pytest.raises(ValueError, match="CUDA"):
        tfce.fused_ce_fwd(h, w, y)
    stats = torch.zeros(h.shape[0])
    with pytest.raises(ValueError, match="CUDA"):
        tfce.fused_ce_bwd_dh(h, w, y, stats, stats, stats)
    with pytest.raises(ValueError, match="CUDA"):
        tfce.fused_ce_bwd_dw(h, w, y, stats, stats, stats)
    with pytest.raises(ValueError, match="CUDA"):
        tfce.fused_ce_bwd(h, w, y, stats, stats, stats)


def _chip_smoke():
    """chip_smoke.py as a module (it runs nothing on import)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16_outs(mask):
    """The card check's pairs for one bf16 case, with the plain versions
    on bf16 inputs standing in for the kernels (the same rounding points:
    dz to bf16 before both products, dh once more) against the f32 plain
    versions on the same values."""
    hidden, wte, labels, _ = _case(V=300, E=64, N=1024, seed=7)
    h = torch.from_numpy(hidden).to(torch.bfloat16)
    w = (torch.from_numpy(wte) * 0.1).to(torch.bfloat16)
    y = torch.from_numpy(labels)
    g = torch.from_numpy(mask) / max(float(mask.sum()), 1.0)
    loss, m, s = tfce.fused_ce_fwd_reference(h, w, y)
    dh, dw = tfce.fused_ce_bwd_reference(h, w, y, m, s, g)
    hf, wf = h.float(), w.float()
    r_loss, r_m, r_s = tfce.fused_ce_fwd_reference(hf, wf, y)
    r_dh, r_dw = tfce.fused_ce_bwd_reference(hf, wf, y, r_m, r_s, g)
    return {"loss": (loss, r_loss), "m": (m, r_m), "s": (s, r_s),
            "dh": (dh, r_dh), "dw": (dw, r_dw)}


@pytest.mark.parametrize("zero_mask", [False, True])
def test_card_check_passes_the_bf16_rounding(zero_mask):
    """The ce phase's bf16 limit (over max |plain|, 2e-2) passes the bf16
    rounding points, with gradients far below 1; an all-zero mask's
    gradients are exactly zero."""
    smoke = _chip_smoke()
    mask = np.full(1024, 0.0 if zero_mask else 1.0, np.float32)
    outs = _bf16_outs(mask)
    assert float(outs["dh"][1].abs().max()) < 0.02 or zero_mask
    errs = smoke._ce_check("cpu", outs, "bfloat16")
    assert max(e for _, e in errs.values()) <= smoke.CE_TOL["bfloat16"]


@pytest.mark.parametrize("key", ["dh", "dw"])
@pytest.mark.parametrize("wrong", ["zero", "negated", "half", "nonzero"])
def test_card_check_fails_a_wrong_gradient(key, wrong):
    """A kernel that returned a zeroed, negated or halved dh or dW (or a
    nonzero one where the plain one is zero) fails the ce phase, though
    every such gradient is below the 2e-2 an absolute limit would take."""
    smoke = _chip_smoke()
    mask = np.full(1024, 0.0 if wrong == "nonzero" else 1.0, np.float32)
    outs = _bf16_outs(mask)
    a, r = outs[key]
    bad = {"zero": a * 0, "negated": -a, "half": a * 0.5,
           "nonzero": a * 0 + 1e-3}[wrong]
    assert float((bad.float() - r).abs().max()) < 2e-2
    outs[key] = (bad, r)
    with pytest.raises(smoke.SmokeFailure, match=key):
        smoke._ce_check("cpu", outs, "bfloat16")


@pytest.mark.parametrize("E,taken", [(768, True), (1024, True),
                                     (1280, True), (1600, True),
                                     (1000, False)])
def test_width_check_takes_every_multiple_of_64(E, taken):
    """The GPT-2 widths 768-1600 are taken for bf16 and f32 dh and dW
    alike (the check no longer depends on the dtype: the bf16 backward
    K-chunks E as the forward does); E 1000 is refused for not being a
    multiple of 64."""
    if taken:
        tfce.check_width(E)
    else:
        with pytest.raises(ValueError, match="multiple of 64"):
            tfce.check_width(E)


@pytest.mark.parametrize("N", [1, 504, 8184])
@pytest.mark.parametrize("V", [64, 50257, 50304])
def test_forward_splits_cover_every_vocab_tile_once(N, V):
    """The bf16 forward's vocab splits (its own 128-row tiles) on 132
    SMs: split i gets tiles [i t, min((i + 1) t, tiles)), t = ceil(tiles /
    splits), as the kernel computes them; every tile falls in exactly one
    split, no split is empty, and the grid fills between half and all of
    the SMs' resident blocks unless one split is enough."""
    sms = 132
    splits = tfce._fwd_splits(N, V, sms)
    tiles = -(-V // tfce.FWD_COLS)
    per = -(-tiles // splits)
    seen = np.zeros(tiles, np.int64)
    for i in range(splits):
        lo, hi = i * per, min(tiles, (i + 1) * per)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()
    row_tiles = -(-N // tfce.FWD_ROWS)
    slots = sms * tfce.FWD_BLOCKS_PER_SM
    assert row_tiles * splits <= max(slots, row_tiles)
    assert splits == 1 or row_tiles * splits > slots // 2


def test_config_takes_gpt2_774m_fused_loss_for_the_card():
    """The miner's config, validated for a run on the card, no longer
    refuses ``gpt2-774m --fused-loss`` (bf16 E 1280): that refusal was a
    check of the preset's width alone."""
    from distributedtraining_tpu_torch.config import RunConfig
    argv = ["--backend", "local", "--model", "gpt2-774m", "--dataset",
            "synthetic", "--tokenizer", "word", "--fused-loss",
            "--no-base-wire-v2", "--checkpoint-interval", "0",
            "--no-anomaly-trace", "--flight-events", "0"]
    cfg = RunConfig.from_args("miner", argv)
    assert cfg.fused_loss and cfg.model == "gpt2-774m"
    cfg.check_ported()


# ---------------------------------------------------------------------------
# The bf16 backward's chunk and split schedule, and its plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [1, 504, 777, 8184])
@pytest.mark.parametrize("V", [300, 1000, 50257, 50304])
def test_backward_schedule_covers_every_column_and_token_once(N, V):
    """The plan dt_ce_bwd walks on 132 SMs: every vocab column of the
    padded Vp falls in exactly one (chunk, dh split) (dh's K is the
    chunk's columns) and every token of the padded Np in exactly one dW
    split of each chunk (dW's K is N); the dz scratch stays within its
    256 MiB unless the chunk is at its floor; the launch count is the
    transposes, two or three launches a chunk (dz, both products, dW's
    split sum) and dh's split sum."""
    E = 768
    plan = tfce._bwd_schedule(N, V, E, 132)
    Np, Vp, Vc = plan["Np"], plan["Vp"], plan["Vc"]
    assert Np % 128 == 0 and Np - 128 < N <= Np
    assert Vp % 128 == 0 and Vp - 128 < V <= Vp
    assert Vc % 128 == 0 and (Vc == Vp or Vc % tfce.FWD_COLS == 0)
    assert 2 * Np * Vc * 2 <= tfce.DZ_SCRATCH_BYTES or Vc == tfce.FWD_COLS
    cols = np.zeros(Vp, np.int64)
    chunks = 0
    for v0 in range(0, Vp, Vc):
        chunks += 1
        wc = min(Vc, Vp - v0)
        for k0, k1 in tfce._k_ranges(wc // tfce.BWD_K, plan["s_dh"]):
            cols[v0 + k0 * tfce.BWD_K:v0 + k1 * tfce.BWD_K] += 1
        toks = np.zeros(Np, np.int64)
        for k0, k1 in tfce._k_ranges(Np // tfce.BWD_K, plan["s_dw"]):
            toks[k0 * tfce.BWD_K:k1 * tfce.BWD_K] += 1
        assert (toks == 1).all()
    assert (cols == 1).all() and chunks == plan["chunks"]
    slots = 132 * tfce.BWD_BLOCKS_PER_SM
    e_tiles = -(-E // tfce.BWD_TILE)
    # one wave at most, none short of one unless K has no more chunks
    for s, tiles, iters in ((plan["s_dh"], -(-N // 128) * e_tiles,
                             Vc // tfce.BWD_K),
                            (plan["s_dw"], Vc // 128 * e_tiles,
                             Np // tfce.BWD_K)):
        assert 1 <= s <= iters and tiles * s <= max(slots, tiles)
        assert s == iters or tiles * (s + 1) > slots
    assert plan["launches"] == (2 + chunks * (2 + (plan["s_dw"] > 1))
                                + (plan["s_dh"] > 1))


def test_backward_schedule_at_the_training_and_miner_shapes():
    """N 8184 takes chunks of 8192 columns with dz in both layouts (7 of
    them, the last 1152 wide) and of 16384 with one, and splits neither
    product (384 output tiles fill the 264 block slots); the miner's
    N 504 takes all of V in one chunk, and its dh (24 output tiles over
    K = V) splits K to fill the card."""
    both = tfce._bwd_schedule(8184, 50304, 768, 132)
    assert (both["Vc"], both["chunks"]) == (8192, 7)
    assert (both["s_dh"], both["s_dw"], both["launches"]) == (1, 1, 16)
    one = tfce._bwd_schedule(8184, 50304, 768, 132, dw=False)
    assert (one["Vc"], one["chunks"]) == (16384, 4)
    miner = tfce._bwd_schedule(504, 50304, 768, 132)
    assert (miner["Vc"], miner["chunks"]) == (50304, 1)
    assert miner["s_dh"] > 1 and 24 * miner["s_dh"] <= 2 * 132


_VC_CASES = {   # (N, V, E, forced chunk, dtype)
    "v_below_chunk": (24, 100, 64, 128, np.float32),
    "v_two_chunks": (24, 256, 64, 128, np.float32),
    "v_two_chunks_and_37": (24, 293, 64, 128, np.float32),
    "e1280_bf16": (16, 300, 1280, 128, "bfloat16"),
}


@pytest.mark.parametrize("case", list(_VC_CASES))
def test_chunked_plain_backward_matches_dense_and_jax(case):
    """The plain version of the bf16 backward's chunked decomposition
    (dz per chunk rounded to h's dtype, dh summed over the chunks in f32
    and rounded once, dW rows per chunk) against the dense plain backward
    and the JAX package's Pallas kernels in interpret mode, at a forced
    small chunk with V below it, at two chunks and two and a bit, and at
    GPT-2-774M's E 1280 in bf16 (the head scaled by sqrt(64 / E), so the
    logits spread as at E 64)."""
    N, V, E, vc, dt = _VC_CASES[case]
    bf16 = dt == "bfloat16"
    hidden, wte, labels, _ = _case(V=V, E=E, N=N, seed=11)
    wte *= np.float32(np.sqrt(64 / E))   # the E 64 cases' logit spread
    dtype = torch.bfloat16 if bf16 else torch.float32
    h = torch.from_numpy(hidden).to(dtype)
    w = torch.from_numpy(wte).to(dtype)
    y = torch.from_numpy(labels)
    g = torch.full((N,), 1.0 / N)
    _, m, s = tfce.fused_ce_fwd_reference(h, w, y)
    dh, dw = tfce.fused_ce_bwd_chunked_reference(h, w, y, m, s, g, vc)
    r_dh, r_dw = tfce.fused_ce_bwd_reference(h, w, y, m, s, g)
    assert dh.dtype == h.dtype and dw.dtype == torch.float32
    # the same dz; only the f32 summation order of dh differs
    np.testing.assert_allclose(dw.numpy(), r_dw.numpy(), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(dh.float().numpy(), r_dh.float().numpy(),
                               rtol=1e-2 if bf16 else 1e-5, atol=1e-8)
    _, _, jdh, jdw = _jax(hidden, wte, labels, None, "pallas",
                          dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tol = (dict(dh=(5e-2, 5e-4), dw=(2e-2, 2e-4)) if bf16
           else dict(dh=(2e-4, 1e-6), dw=(2e-4, 1e-6)))
    np.testing.assert_allclose(dh.float().numpy(),
                               np.asarray(jdh, np.float32),
                               rtol=tol["dh"][0], atol=tol["dh"][1])
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw),
                               rtol=tol["dw"][0], atol=tol["dw"][1])
