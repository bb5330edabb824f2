"""The paged window (``W > 1`` queries a slot) of the port's
ops/paged_attention.py against the JAX package's XLA spelling,
``paged_decode_reference`` with ``Tq > 1``, on the CPU.

The port's plain version is the window kernel's oracle on the card
(chip_smoke.py phase 21) and the CPU path of the suffix prefill and the
speculative verify. Query ``t`` of a slot sees the slot's context below
``seq_lens`` (through the page table) and the window's fresh rows
``0..t``. Held at f32 within 1e-6 (summation order), for windows of 1 to
16 queries, contexts of 0 and at page boundaries, GQA, padded lanes
(context 0, tables on trash page 0, which is poisoned so a leak would
show), and the dispatch: CPU tensors take the plain version at any
window, CUDA tensors are refused by the wrappers' checks off the card.

``paged_window_split_reference`` (the bf16 kernel's walk: 64-row key
tiles in the planner's splits, P split into two bf16 parts before PV,
the splits merged) is held to the same JAX function within 1e-5 in f32,
at the cases above, a 64-row window over 900 positions and the edges of
pages and splits; in bf16 it reads at most half of chip_smoke.py's card
limit, where P rounded once to bf16 or a dropped split read past it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu.ops import paged_attention as jpa
from distributedtraining_tpu_torch.ops import paged_attention as pa

P = 8


def _case(B, W, Hq, Hkv, D, MP, lens, seed):
    rng = np.random.default_rng(seed)
    pool = 1 + B * MP
    q = rng.standard_normal((B, W, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((pool, P, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((pool, P, Hkv, D)).astype(np.float32)
    kp[0] = 1e3      # trash page: a leak of it would show
    vp[0] = 1e3
    kn = rng.standard_normal((B, W, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, W, Hkv, D)).astype(np.float32)
    tables = np.zeros((B, MP), np.int32)
    perm = rng.permutation(pool - 1) + 1
    for b, n in enumerate(lens):
        used = (n + P - 1) // P
        tables[b, :used] = perm[b * MP:b * MP + used]
    return q, kp, vp, tables, np.asarray(lens, np.int32), kn, vn


def _both(args):
    ref = np.asarray(jpa.paged_decode_reference(*map(jnp.asarray, args)))
    ours = pa.paged_attention(*map(torch.from_numpy, args)).numpy()
    return ours, ref


@pytest.mark.parametrize("W", [1, 2, 5, 16])
@pytest.mark.parametrize("lens", [[0, 7, 8, 9], [16, 15, 17, 31]])
def test_window_matches_jax_reference(W, lens):
    args = _case(4, W, 4, 4, 16, 4, lens, W)
    ours, ref = _both(args)
    assert ours.shape == (4, W, 4, 16)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 1)])
def test_window_gqa_matches_jax_reference(Hq, Hkv):
    args = _case(3, 6, Hq, Hkv, 16, 4, [0, 9, 32], 11)
    ours, ref = _both(args)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_query_t_sees_fresh_rows_up_to_t_only():
    """Changing fresh row f moves the outputs of queries t >= f and no
    other; a padded lane (context 0) sees only its own window."""
    args = list(_case(2, 5, 2, 2, 16, 2, [9, 0], 3))
    base = pa.paged_attention(*map(torch.from_numpy, args)).numpy()
    for f in range(5):
        moved = [a.copy() for a in args]
        moved[5][:, f] += 1.0
        moved[6][:, f] -= 1.0
        out = pa.paged_attention(*map(torch.from_numpy, moved)).numpy()
        changed = np.abs(out - base).max(axis=(0, 2, 3)) > 0
        assert changed.tolist() == [t >= f for t in range(5)]
    # lane 1 has no context: its first query attends its own row alone
    np.testing.assert_allclose(base[1, 0], np.repeat(
        args[6][1, 0], 1, axis=0), atol=1e-6)


def test_padded_rows_past_the_input_leave_real_rows_unchanged():
    """Rows at or past a lane's ``n_input`` (the verify's padding) only
    change the queries at or after them, never an earlier real one."""
    args = list(_case(2, 5, 2, 2, 16, 3, [17, 4], 5))
    base = pa.paged_attention(*map(torch.from_numpy, args)).numpy()
    junk = [a.copy() for a in args]
    junk[0][:, 3:] = 99.0
    junk[5][:, 3:] = -7.0
    junk[6][:, 3:] = 5.0
    out = pa.paged_attention(*map(torch.from_numpy, junk)).numpy()
    np.testing.assert_array_equal(out[:, :3], base[:, :3])


def test_cuda_tensors_are_never_given_the_plain_version():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = [torch.from_numpy(a) for a in _case(1, 3, 2, 2, 64, 2, [5], 0)]
    for fn in (pa.paged_window_attention, pa.paged_decode_attention):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    assert pa.window_launches == 0 and pa.launches == 0


def _chip_smoke():
    """chip_smoke.py as a module (it runs nothing on import)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("W,lens", [(5, [8, 200, 900]), (64, [900])])
def test_card_bf16_limit_passes_rounding_and_rejects_a_lost_tile(W, lens):
    """The window phase's bf16 limit (per element, against the plain
    version in f32 on the same inputs) passes the f32 result rounded
    once to bf16, as the kernel stores it, and fails the plain version
    with the last 32 context rows of each lane dropped, and the bf16
    plain version, which rounds the probabilities before PV."""
    smoke = _chip_smoke()
    smoke.DEV = "cpu"
    args = smoke._window_case(len(lens), W, lens, torch.bfloat16, 3,
                              Hq=4, Hkv=4, D=64, MP=64)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    ref = pa.paged_decode_reference(*f32)
    assert smoke._window_bf16_ratio(ref.to(torch.bfloat16), ref) <= 0.5
    short = torch.clamp(f32[4] - 32, min=0)
    lost = pa.paged_decode_reference(*f32[:4], short, *f32[5:])
    assert smoke._window_bf16_ratio(lost, ref) > 10.0
    assert smoke._window_bf16_ratio(pa.paged_decode_reference(*args),
                                    ref) > 1.0


# the split reference against JAX in f32: (B, W, Hq, Hkv, MP, lens,
# tiles); tiles None is the planner's. With P 8 a 64-row key tile is 8
# pages: contexts P - 1, P, P + 1, one tile (a split at tiles 1) +- 1, two
# tiles +- 1, the table's width - 1 and the width
SPLIT_CASES = {
    **{f"w{W}_{i}": (4, W, 4, 4, 4, lens, None)
       for W in (1, 2, 5, 16)
       for i, lens in enumerate(([0, 7, 8, 9], [16, 15, 17, 31]))},
    "gqa_8_2": (3, 6, 8, 2, 4, [0, 9, 32], None),
    "gqa_4_1": (3, 6, 4, 1, 4, [0, 9, 32], None),
    "w64_ctx900": (1, 64, 4, 4, 128, [900], None),
    "edges_t1": (5, 5, 4, 4, 32, [7, 8, 9, 63, 64], 1),
    "edges_t1b": (5, 5, 4, 4, 32, [65, 127, 128, 129, 255], 1),
    "edges_t2": (5, 70, 4, 4, 32, [127, 128, 129, 255, 256], 2),
    "edges_gqa_t3": (2, 70, 8, 2, 32, [191, 193], 3),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_window_split_reference_matches_jax_reference(case):
    B, W, Hq, Hkv, MP, lens, tiles = SPLIT_CASES[case]
    args = _case(B, W, Hq, Hkv, 16, MP, lens, 7)
    ref = np.asarray(jpa.paged_decode_reference(*map(jnp.asarray, args)))
    ours = pa.paged_window_split_reference(*map(torch.from_numpy, args),
                                           tiles=tiles).numpy()
    assert ours.shape == (B, W, Hq, 16)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


# bf16 against the card limit: (B, W, lens, Hq, Hkv, D)
BF16_CASES = {"verify_w5": (3, 5, [8, 200, 900], 4, 4, 64),
              "suffix_w64": (1, 64, [900], 4, 4, 64),
              "suffix_w512": (1, 512, [900], 2, 2, 64),
              "gqa_w33_d128": (2, 33, [17, 200], 8, 2, 128)}


def _bf16_case(name):
    B, W, lens, Hq, Hkv, D = BF16_CASES[name]
    smoke = _chip_smoke()
    smoke.DEV = "cpu"
    args = smoke._window_case(B, W, lens, torch.bfloat16, 5, Hq=Hq, Hkv=Hkv,
                              D=D, MP=64)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    return smoke, args, pa.paged_decode_reference(*f32)


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_window_split_reference_bf16_within_half_the_card_limit(name):
    """The kernel's rounding points (P in two bf16 parts, the output
    rounded once at the store) read at most half of the card's per
    element limit against the plain version in f32."""
    smoke, args, ref = _bf16_case(name)
    out = pa.paged_window_split_reference(*args)
    assert out.dtype == torch.bfloat16
    assert smoke._window_bf16_ratio(out, ref) <= 0.5


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_card_limit_fails_p_rounded_once_and_a_dropped_split(name):
    """The same limit rejects the walk with P rounded once to bf16
    before PV (the flash kernel's rounding point) and the merge without
    the first split, the one that holds the context's first tiles."""
    smoke, args, ref = _bf16_case(name)
    once = pa.window_split_merge(
        *pa.window_split_partials(*args, p_parts=1), args[0])
    assert smoke._window_bf16_ratio(once, ref) > 1.0
    m, l, acc = pa.window_split_partials(*args)
    assert m.shape[-1] > 1
    m[..., 0], l[..., 0], acc[..., 0, :] = float("-inf"), 0.0, 0.0
    dropped = pa.window_split_merge(m, l, acc, args[0])
    assert smoke._window_bf16_ratio(dropped, ref) > 1.0


@pytest.mark.parametrize("W,G,MP,P,B,Hkv,want", [
    (5, 1, 64, 16, 8, 12, (5, 4)),      # the verify
    (512, 1, 64, 16, 1, 12, (6, 4)),    # a 512-row suffix over 900
    (64, 1, 64, 16, 1, 12, (1, 17)),    # a 64-row suffix
    (1024, 1, 64, 16, 8, 12, (32, 1)),  # a full grid: no split
    (33, 4, 16, 16, 2, 8, (1, 5)),
    (5, 1, 64, 16, 65535, 1, (17, 1)),  # the grid's z limit
])
def test_plan_window_fills_one_wave(W, G, MP, P, B, Hkv, want):
    """Splits of whole key tiles covering the walk once, as many as keep
    the grid within the blocks one wave holds."""
    plan = pa.plan_window(W, G, MP, P, B, Hkv)
    key_tiles = -(-MP * P // 64) + -(-W // 64)
    assert (plan.tiles, plan.splits) == want
    assert plan.splits * plan.tiles >= key_tiles
    assert (plan.splits - 1) * plan.tiles < key_tiles
    blocks = -(-W * G // 64) * Hkv * B * plan.splits
    assert plan.splits == 1 or blocks <= pa._WIN_BLOCKS
    assert B * plan.splits <= 65535
