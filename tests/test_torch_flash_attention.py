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
brute-force causal and segment mask, and the plain version of the bf16
backward kernels' walk along those lists
(``flash_attention_bwd_tiled_reference``) against the dense plain
backward and ``jax.grad``. The CUDA kernels themselves run only on the
card, where chip_smoke.py holds them against these plain versions; the
helper by which it checks that two calls give the same bits is pinned
here.
"""

import importlib.util
import pathlib


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


def _bwd_inputs(layout, T, seed, B=2, H=3, D=16):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                   for _ in range(4))
    return q, k, v, do, _segment_ids(layout, B, T, seed)


@pytest.mark.parametrize("T", (17, 64, 129, 300))
@pytest.mark.parametrize("layout", ("packed", "scattered", "unpacked"))
def test_tiled_bwd_reference_matches_dense_and_jax_grad(layout, T):
    """The backward along the kernels' lists (dq by row of
    ``visible_key_tiles``, dk/dv by column, exp2 units) equals the dense
    plain backward and ``jax.grad`` of the package's dense attention in
    f32: no listed tile is missing a visible pair, and no pair counts
    twice. Unpacked runs without ids, as the kernels then list every
    causal tile."""
    q, k, v, do, seg = _bwd_inputs(layout, T, seed=T + len(layout))
    ids = None if layout == "unpacked" else _t(seg)
    o, lse = tfa.flash_attention_reference(_t(q), _t(k), _t(v), ids)
    tiled = tfa.flash_attention_bwd_tiled_reference(
        _t(q), _t(k), _t(v), o, lse, _t(do), ids)
    dense = tfa.flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), o, lse, _t(do), ids)
    grads = _jax_dense_grads(q, k, v, do, seg)
    for ours, ref, jref in zip(tiled, dense, grads):
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(ours.numpy(), np.asarray(jref), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("layout", ("packed", "scattered", "unpacked"))
def test_tiled_bwd_reference_rounds_p_and_ds_in_bf16(layout):
    """With bf16 inputs the walk rounds P and dS to bf16 before their
    products, as the kernels do: its bf16 grads are within the card's
    limit (2e-2 of max(1, |value|)) of the dense plain backward on the
    same values in f32, and they differ from the walk on those values
    in f32 (where nothing is rounded) by more than the final rounding to
    bf16 alone."""
    q, k, v, do, seg = _bwd_inputs(layout, 300, seed=31)
    ids = None if layout == "unpacked" else _t(seg)
    x = [_t(a).to(torch.bfloat16) for a in (q, k, v, do)]
    f = [a.float() for a in x]
    o, lse = tfa.flash_attention_reference(*f[:3], ids)
    low = tfa.flash_attention_bwd_tiled_reference(
        *x[:3], o.to(torch.bfloat16), lse, x[3], ids)
    dense = tfa.flash_attention_bwd_reference(
        *f[:3], o.to(torch.bfloat16).float(), lse, f[3], ids)
    exact = tfa.flash_attention_bwd_tiled_reference(
        *f[:3], o.to(torch.bfloat16).float(), lse, f[3], ids)
    for ours, ref, ex in zip(low, dense, exact):
        assert ours.dtype == torch.bfloat16
        err = ((ours.float() - ref).abs() / ref.abs().clamp(min=1)).max()
        assert float(err) <= 2e-2
        # rounding the exact result once moves no element by more than
        # half an ulp; rounding P and dS first moves some by more
        once = (ex.to(torch.bfloat16).float() - ex).abs()
        assert bool(((ours.float() - ex).abs() > once).any())


def _chip_smoke():
    """chip_smoke.py as a module (it runs nothing on import)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_card_determinism_check_sees_one_changed_bit(dtype):
    """The phase 4 check that two calls give the same dq, dk and dv: two
    runs of the plain backward pass it (NaNs at the same place too), and
    one element moved by one ulp, or a zero turned into -0.0, fails it by
    name."""
    smoke = _chip_smoke()
    q, k, v, do, seg = _bwd_inputs("packed", 70, seed=3)
    x = [_t(a).to(dtype) for a in (q, k, v, do)]
    o, lse = tfa.flash_attention_reference(*x[:3], _t(seg))

    def run():
        dq, dk, dv = tfa.flash_attention_bwd_reference(
            *x[:3], o, lse, x[3], _t(seg))
        return {"dq": dq, "dk": dk, "dv": dv}

    first, second = run(), run()
    assert smoke._differs_bitwise(first, second) == []
    for out in (first, second):
        out["dk"][0, 0, 0, 0] = float("nan")
    assert smoke._differs_bitwise(first, second) == []
    moved = dict(second)
    moved["dq"] = second["dq"].clone()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    moved["dq"].view(bits)[1, 5, 2, 3] += 1     # the next float up
    assert smoke._differs_bitwise(first, moved) == ["dq"]
    signed = dict(second)
    signed["dv"] = second["dv"].clone()
    signed["dv"][0, 1, 0, 0] = 0.0
    first["dv"][0, 1, 0, 0] = -0.0
    assert smoke._differs_bitwise(first, signed) == ["dv"]
