"""Flash attention in the PyTorch port (distributedtraining_tpu_torch/
ops/flash_attention.py) against the JAX side, on the CPU.

On the CPU the port's ``flash_attention`` runs its plain versions, the
same formulas its CUDA kernels implement (forward with a saved lse;
backward recomputing P from it). They are held, in f32, against the
Pallas library's own reference (``mha_reference_no_custom_vjp`` with
``save_residuals=True``), the JAX package's dense attention
(``dot_product_attention`` + ``combine_masks``) and its blockwise
attention, and their gradients against ``jax.grad`` of the dense
attention. Tolerance 1e-5 absolute on unit-scale inputs: only the
summation order differs. The key-tile list the bf16 forward kernel walks
(``visible_key_tiles``, the Python mirror of its rule) is held against a
brute-force causal and segment mask. The CUDA kernels themselves run
only on the card, where chip_smoke.py holds them against these plain
versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as lib

from distributedtraining_tpu.ops import attention as jatt
from distributedtraining_tpu_torch.data import packing
from distributedtraining_tpu_torch.ops import attention as tatt
from distributedtraining_tpu_torch.ops import flash_attention as tfa

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, T, H, D, packed, seed):
    """Unit-normal q, k, v ``[B, T, H, D]`` and, when ``packed``, segment
    ids from random document lengths (non-decreasing per row, the
    packer's layout)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                   for _ in range(4))
    seg = None
    if packed:
        seg = np.zeros((B, T), np.int32)
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(1, max(T, 2)),
                                      size=min(3, max(T - 1, 0)),
                                      replace=False)) if T > 1 else []
            for c in cuts:
                seg[b, c:] += 1
    return q, k, v, do, seg


def _t(a):
    return None if a is None else torch.from_numpy(a)


CASES = [(T, D, packed) for T in (1, 17, 64, 128, 300) for D in (16, 64)
         for packed in (False, True)]


def _case_id(c):
    return f"T{c[0]}-D{c[1]}-{'packed' if c[2] else 'plain'}"


@jax.jit
def _jax_forwards(q, k, v, seg):
    """The library's reference (in its [B, H, T, D] layout; its lse is
    m + log l), the package's dense and blockwise attention, as one
    program per shape. An all-zero ``seg`` is the unpacked case."""
    T, D = q.shape[1], q.shape[3]
    tr = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
    o, l, m = lib.mha_reference_no_custom_vjp(
        tr(q), tr(k), tr(v), segment_ids=lib.SegmentIds(q=seg, kv=seg),
        causal=True, sm_scale=D ** -0.5, save_residuals=True)
    dense = jatt.dot_product_attention(
        q, k, v, jatt.combine_masks(jatt.make_causal_mask(T), None, seg))
    block = jatt.blockwise_attention(q, k, v, segment_ids=seg, block_q=32,
                                     block_kv=16)
    return tr(o), m + jnp.log(l), dense, block


def _zeros_if_none(seg, q):
    return np.zeros(q.shape[:2], np.int32) if seg is None else seg


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_forward_and_lse_match_library_and_package(case):
    T, D, packed = case
    q, k, v, _, seg = _inputs(2, T, 2, D, packed, seed=T * 7 + D)
    o, lse = tfa.flash_attention_reference(_t(q), _t(k), _t(v), _t(seg))
    assert o.shape == (2, T, 2, D) and lse.shape == (2, 2, T)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    lib_o, lib_lse, dense, block = _jax_forwards(q, k, v,
                                                 _zeros_if_none(seg, q))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lib_lse), rtol=0,
                               atol=TOL)
    for ref in (lib_o, dense, block):
        np.testing.assert_allclose(o.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)


@jax.jit
def _jax_dense_grads(q, k, v, do, seg):
    """``jax.grad`` of the package's dense attention against the
    cotangent ``do`` (an all-zero ``seg`` is the unpacked case)."""
    T = q.shape[1]

    def f(a, b, c):
        mask = jatt.combine_masks(jatt.make_causal_mask(T), None, seg)
        return jnp.sum(jatt.dot_product_attention(a, b, c, mask) * do)

    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_gradients_match_jax_grad_of_dense(case):
    """dq, dk, dv through the autograd Function (the plain backward on
    the CPU, the kernels' formulas) vs ``jax.grad`` of the package's
    dense attention. The cotangent ``do`` is a non-contiguous view, as
    autograd may hand the kernels one."""
    T, D, packed = case
    q, k, v, do, seg = _inputs(2, T, 2, D, packed, seed=T * 11 + D + 1)
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    o = tfa.flash_attention(qt, kt, vt, _t(seg))
    do_t = _t(np.ascontiguousarray(do.transpose(0, 2, 1, 3))).transpose(
        1, 2)
    assert T == 1 or not do_t.is_contiguous()
    o.backward(do_t)
    for ours, ref in zip((qt.grad, kt.grad, vt.grad),
                         _jax_dense_grads(q, k, v, do,
                                          _zeros_if_none(seg, q))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("impl", ["dense", "blockwise", "flash"])
def test_every_causal_attention_impl_is_differentiable(impl):
    """Training may run any impl: each path's autograd gradients equal
    ``jax.grad`` of the package's dense attention (packed segments)."""
    q, k, v, do, seg = _inputs(2, 40, 2, 16, True, seed=5)
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = tatt.causal_attention(qt, kt, vt, segment_ids=_t(seg), impl=impl)
    out.backward(_t(do))
    for ours, ref in zip((qt.grad, kt.grad, vt.grad),
                         _jax_dense_grads(q, k, v, do,
                                          _zeros_if_none(seg, q))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)


def test_fused_qkv_views_match_contiguous_inputs():
    """q, k, v as the model makes them (strided views of one fused
    ``[B, T, 3E]`` projection, token stride 3E) give the same output and
    gradient as contiguous copies."""
    B, T, H, D = 2, 33, 2, 16
    E = H * D
    rng = np.random.default_rng(9)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * E)).astype(
        np.float32)).requires_grad_()
    views = [x.reshape(B, T, H, D) for x in qkv.split(E, dim=-1)]
    assert views[1].stride() == (T * 3 * E, 3 * E, D, 1)
    out = tfa.flash_attention(*views)
    out.sum().backward()
    copies = [x.detach().contiguous().requires_grad_() for x in views]
    ref = tfa.flash_attention(*copies)
    ref.sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref.detach().numpy())
    grad = torch.cat([c.grad.reshape(B, T, E) for c in copies], dim=-1)
    np.testing.assert_array_equal(qkv.grad.numpy(), grad.numpy())


def test_bwd_reference_matches_autograd_of_the_forward():
    """The plain backward's formulas (P from the saved lse, di = rowsum
    o * do) equal autograd through the plain forward."""
    q, k, v, do, seg = _inputs(1, 50, 3, 16, True, seed=13)
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    o, lse = tfa.flash_attention_reference(qt, kt, vt, _t(seg))
    o.backward(_t(do))
    dq, dk, dv = tfa.flash_attention_bwd_reference(
        *(x.detach() for x in (qt, kt, vt, o, lse)), _t(do), _t(seg))
    for ours, ref in zip((dq, dk, dv), (qt.grad, kt.grad, vt.grad)):
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=0,
                                   atol=TOL)


def test_dispatch_cpu_runs_plain_versions_and_kernels_refuse_cpu():
    """CPU tensors take the plain versions and count no launch; the
    kernel entries refuse CPU tensors rather than fall back; nothing in
    this process built or loaded the CUDA library (importing the module
    needs no nvcc)."""
    before = dict(tfa.launches)
    q, k, v, do, seg = _inputs(1, 20, 2, 64, True, seed=17)
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    tfa.flash_attention(qt, kt, vt, _t(seg)).backward(_t(do))
    assert tfa.launches == before
    o, lse = tfa.flash_attention_reference(_t(q), _t(k), _t(v))
    di = (o * _t(do)).sum(-1).transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(_t(q), _t(k), _t(v))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dkv(_t(q), _t(k), _t(v), _t(do), lse, di)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dq(_t(q), _t(k), _t(v), _t(do), lse, di)
    assert tfa.launches == before
    assert tfa._kernels.cache_info().currsize == 0


def _segment_ids(layout, B, T, seed):
    """``[B, T]`` int32 ids: the packer's rows of documents of 10-200
    tokens (contiguous ids, the padding tail its own id), ids in no order,
    or one document (unpacked)."""
    rng = np.random.default_rng(seed)
    if layout == "packed":
        docs = (list(range(int(n))) for n in rng.integers(10, 201, 10 * B))
        rows = packing.pack_documents(docs, T, drop_remainder=False)
        return np.stack([next(rows)["segment_ids"] for _ in range(B)])
    if layout == "scattered":
        return rng.integers(0, 4, (B, T)).astype(np.int32)
    return np.zeros((B, T), np.int32)


def _tiles_with_visible_pairs(seg, T, tile=64):
    """``[B, n, n]``: whether query tile qt and key tile kt hold a pair
    (i, j) with j <= i and the same id, by brute force."""
    n = -(-T // tile)
    pos = np.arange(T)
    vis = (pos[:, None] >= pos[None, :])[None] & (
        seg[:, :, None] == seg[:, None, :])
    out = np.zeros((seg.shape[0], n, n), bool)
    for qt in range(n):
        for kt in range(n):
            out[:, qt, kt] = vis[:, qt * tile:(qt + 1) * tile,
                                 kt * tile:(kt + 1) * tile].any((1, 2))
    return out


@pytest.mark.parametrize("T", (1, 17, 64, 300, 777))
@pytest.mark.parametrize("layout", ("packed", "scattered", "unpacked"))
def test_visible_key_tiles_cover_every_visible_pair(layout, T):
    """No visible pair lies in a key tile the forward kernel leaves out;
    for the packer's contiguous ids (and one document) the list is exactly
    the tiles that hold a visible pair."""
    seg = _segment_ids(layout, 3, T, seed=T)
    listed = tfa.visible_key_tiles(torch.from_numpy(seg), T).numpy()
    needed = _tiles_with_visible_pairs(seg, T)
    assert listed.shape == needed.shape == (3, -(-T // 64), -(-T // 64))
    assert not (needed & ~listed).any()
    if layout != "scattered":
        np.testing.assert_array_equal(listed, needed)



def test_a_refused_shape_raises_value_error_and_counts_no_launch():
    """The C entries own the shape limits (the bf16 forward's key-tile
    list in shared memory bounds T): the error they return before
    launching reads as ValueError, any other error as RuntimeError, and
    neither counts a launch."""
    before = dict(tfa.launches)
    with pytest.raises(ValueError, match="does not take"):
        tfa._raise_on(1, "flash_attention_fwd")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tfa._raise_on(700, "flash_attention_fwd")
    assert tfa.launches == before
