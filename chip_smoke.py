#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (distributedtraining_tpu_torch) on one
NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root

Phases, each of which fails the run (non-zero exit, no result line):

1. env     CUDA must be available (there is no CPU fallback); prints the
           card's name and power limit, torch/CUDA versions, capability.
2. build   compiles every CUDA source under csrc/, one nvcc each, all
           started together; reports seconds, registers and spills per
           kernel (ptxas -v).
3. kernel  holds the paged-decode kernel against its plain PyTorch
           version at the GPT-2-124M decode shape and a GQA shape, in
           f32 (TF32 off; max abs <= 1e-5, the summation order differs)
           and in bf16 (max abs <= 2e-2: the plain version rounds the
           softmax probabilities to bf16 before PV, the kernel keeps
           f32); times kernel, plain version and a library yardstick.
4. flash   holds the flash-attention forward (o, lse) and backward
           (dq, dk, dv) kernels against their plain versions: the
           training shape (B 8, T 1024, H 12, D 64) with segment ids from
           a real packed batch, T 64 and 512, a ragged T, D 128, an
           unpacked case and ids in no order; q, k, v as strided views of
           a fused [B, T, 3E] projection. f32: max abs <= 1e-5 forward,
           <= 1e-4 gradients (summation order); bf16: <= 2e-2 against the
           plain version's unrounded f32 result on the same inputs, each
           difference divided by max(1, |value|) (the bf16 kernels round P
           and dS before their products, as the library does, and the
           output once, each rounding up to 2^-8 of the value; gradients
           exceed 4 at T 1024). Times
           each kernel at the training shape in bf16 (L2 flushed, median
           of 30) beside its bound, the plain version and SDPA.
5. slice   GPT-2-124M, full width and depth, f32: GenerationEngine's
           greedy output is token-identical to reference_generate.
6. serve   the same weights at the served bf16 compute dtype behind
           ServeLoop + ServeHTTPFrontend: 8 concurrent POST /generate
           requests (prompts of 8-900 tokens, 32 new tokens each) all
           finish, and the decode steps went through the kernel
           (launches == n_layer x decode dispatches > 0).
7. profile torch.profiler over steady decode steps of the same batch:
           wall vs device time per step, idle share, top kernels.
8. train   GPT-2-124M, full width and depth, bf16 compute, f32 params:
           20 TrainEngine.train_steps at B 8, T 1024 on shuffled packed
           synthetic batches, then evaluate at T 512 on held-out batches
           for the base and for apply_delta(base, compute_delta(trained,
           base)). Losses finite and falling, delta finite, score =
           base - trained loss > 0, flash forward launches == 12 x
           (steps + eval batches), dk/dv and dq launches == 12 x steps.
9. parity  the same model in f32 at B 2, T 256: 3 steps through the
           kernels and 3 with attention forced to the plain versions
           (a test hook that patches the dispatch); losses agree within
           1e-4 relative.
10. tprof  torch.profiler over steady train steps at B 8, T 1024: wall vs
           device time per step, idle share, device time by kernel.
11. ce     holds the fused cross-entropy forward, dh and dW kernels against
           their plain versions: the training shape (N 8184, V 50304,
           E 768) with bf16 h, the f32 head and the loss mask of a real
           packed batch, the miner's N 504, a ragged N, a vocab that is not
           a multiple of the tile, labels in the last column, an all-zero
           mask, f32 at a small shape, f32 with one vocab split, and the
           forward alone at GPT-2-774M's bf16 width (E 1280, which dh and
           dW do not take) and with one vocab split (N 131072).
           Limits per output: in f32 max |kernel - plain| / max(1,
           max |plain|) <= 1e-5 (summation order); in bf16
           max |kernel - plain| / max |plain| <= 2e-2 against the plain
           version's f32 result on the same values (dz rounded to bf16
           before both products, as the TPU kernels round it, and dh once
           more at the end), and an exactly-zero plain output must come
           back exactly zero. Each case also checks that the limit fails
           a planted wrong gradient (dh or dW zeroed, or negated). Times
           each kernel in bf16 at N 8184 and N 504 (L2 flushed, median
           of 30) beside its bound, the plain version and the
           materialised path (two library calls: a cuBLAS bf16 GEMM to
           the logits and F.cross_entropy; its backward); at N 504 the
           forward and dh also with their vocab splits forced to 1.
12. tfused phase 8 again with TrainEngine(fused_loss=True): 20 steps at B 8,
           T 1024, eval at T 512; fused CE forward launches == steps +
           eval batches, dh == dW == steps, flash counts as in phase 8;
           then the train profile with the CE kernels' device time.
13. fparity f32 at B 2, T 256: 3 steps with fused_loss=True (the f32 CE
           kernels) and 3 without; losses agree within 1e-4 relative.
14. miner  the port's miner at GPT-2-124M full width with the fused loss:
           MinerLoop in-process over a LocalFSTransport in a temporary
           directory on a FakeClock advanced per batch (seq 64, batch 8):
           a base published before boot (bootstrap pulls it), a second one
           mid-run (pulled, optimizer reset), >= 2 pushes, the self-eval
           guard on. The artifact decodes against the template and is
           finite, its rider names the second base, base + delta scores
           > 0 on held-out batches against that base, and the CE and flash
           launches equal the steps and evals the loop ran. Then
           ``neurons.miner.main`` once with the README's flags for a few
           steps; it must leave a pushed delta on disk.
15. scatter holds the dequantize-scatter-add kernel against its plain
           version (run on CPU copies, where index_add_ adds in index
           order): one leaf at a time, int8 and f32 q, unique,
           random-duplicate and all-equal indices, k 1, wte's n
           (38,633,472 > 2^24) with duplicates; then all 50 indexed leaves
           of one GPT-2-124M wire-v2 contribution in one call of the
           contribution entry (one launch), and the same contribution with
           one leaf carrying duplicates (the ordered path and the plain
           one in one launch). Limit: bit-exact (max |kernel - plain| =
           0), and the check must reject a planted wrong result (one entry
           dropped, one value negated) in every one-leaf case. Times the
           wte leaf and the whole contribution, each one call of the
           contribution entry (L2 flushed, median of 30; and the host
           time of a call), beside the byte bound, the plain version on
           the card and index_add_.
16. averager the port's averager round at GPT-2-124M full width and depth
           over LocalFS and a LocalChain in a temporary directory: genesis
           publish; a MinerLoop --wire-v2 miner (fused loss, seq 64, batch
           8, 4 steps), packed int8 and f32 miners, a dense v1 miner, an
           index-out-of-range miner (no_delta) and an over-cap one
           (magnitude_exceeded), weights from LocalChain.set_weights.
           Round 1: the packed submissions reach the merge un-densified,
           dequant_scatter launches == 3 packed contributions (one
           launch each, for their 50 indexed leaves),
           flash forward == 12 x evaluated batches, the published base
           equals base + sum w_i decode(d_i) by the plain versions within
           1e-6, the improved guard publishes. Round 2: the miner pulls,
           trains and pushes; it is merged, the rest are skipped as
           stale. Then ``neurons.averager.main`` with the README's flags
           for one round must publish a new base and return 0. Prints the
           round's wall time split into ingest, merge and eval, the
           merge's device time from torch.profiler, its idle share and
           the peak memory.

Output: a ``kernels`` JSON line, a ``slice`` JSON line, a ``train`` JSON
line, a ``miner`` JSON line, an ``averager`` JSON line, the
``nvidia-smi`` name/power-limit line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores, same sheet
H100_BF16_FLOPS = 989e12       # bf16 tensor cores, dense, same sheet
SEED = 0
DEV = "cuda"        # where the scatter and averager phases place tensors
TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 1024, 20
EVAL_T, EVAL_BATCHES = 512, 4


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# 1. env
# ---------------------------------------------------------------------------

def phase_env() -> str:
    import torch
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: this script runs only on "
          "a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    # matmul TF32 is off by default, cuDNN's is on: state both
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"env": {
        "nvidia_smi": card, "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "capability": list(torch.cuda.get_device_capability(0)),
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def _ptxas_report(text: str) -> dict:
    """Registers and spill bytes per compiled entry function, from
    ``nvcc -Xptxas -v`` output, keyed by the kernel's base name and
    template arguments as ptxas prints them (mangled)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "spill_bytes": 0}
            continue
        if name is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_bytes"] += int(m.group(1)) + int(m.group(2))
    return out


def phase_build() -> dict:
    """One nvcc per source under csrc/, all started together."""
    from distributedtraining_tpu_torch.ops import _cuda
    names = _cuda.sources()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        secs = dict(zip(names, ex.map(_cuda.build, names)))
    build_s = time.perf_counter() - t0
    out = {"build_s": build_s, "sources": {}}
    for name in names:
        lib = _cuda.library_path(name)
        log_path = lib.with_name(lib.name + ".log")
        per_kernel = _ptxas_report(log_path.read_text()
                                   if log_path.exists() else "")
        regs = [k["registers"] for k in per_kernel.values()
                if k["registers"] is not None]
        out["sources"][name] = {
            "nvcc_s": secs[name], "instantiations": len(per_kernel),
            "max_registers": max(regs) if regs else None,
            "kernels_with_spills": sum(1 for k in per_kernel.values()
                                       if k["spill_bytes"]),
            "kernels": per_kernel}
    print(json.dumps({"build": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# 3. kernel
# ---------------------------------------------------------------------------

def _decode_case(B, Hq, Hkv, D, P, MP, lens, dtype, seed):
    """Random q/pool/fresh column; each lane's table names distinct
    pages for its used entries and trash page 0 for the rest (the
    engine's layout); page 0 is poisoned so a leak would show."""
    import torch
    g = torch.Generator().manual_seed(seed)
    pool = 1 + B * MP
    q = torch.randn((B, 1, Hq, D), generator=g)
    kp = torch.randn((pool, P, Hkv, D), generator=g)
    vp = torch.randn((pool, P, Hkv, D), generator=g)
    kp[0] = 1e3
    vp[0] = 1e3
    kn = torch.randn((B, 1, Hkv, D), generator=g)
    vn = torch.randn((B, 1, Hkv, D), generator=g)
    tables = torch.zeros((B, MP), dtype=torch.int32)
    perm = torch.randperm(pool - 1, generator=g) + 1
    for b, n in enumerate(lens):
        used = (n + P - 1) // P
        tables[b, :used] = perm[b * MP:b * MP + used].to(torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32)
    dev = "cuda"
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            tables.to(dev), sl.to(dev), kn.to(dev, dtype),
            vn.to(dev, dtype))


def _time_ms(fn, reps: int = 30, warm: int = 5) -> float:
    """Median CUDA-event time of one call. A 256 MiB write before each
    timed call evicts the 50 MB L2 (a decode step finds each layer's
    pages cold) and keeps the device busy while the host enqueues."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _host_ms(fn, reps: int = 30, warm: int = 5) -> float:
    """Median host time of one call, from an idle device (synchronised
    before each call, not after it): what the call costs its caller
    before the device has done any of its work."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _bound(args, elt: int) -> tuple[float, str]:
    """Least time for the function on these inputs: bytes it must move
    (K/V rows the seq_lens reach, q, fresh column, out, tables) over the
    memory rate vs its f32 arithmetic over the f32 rate."""
    q, kp, _, tables, sl, _, _ = args
    B, _, Hq, D = q.shape
    _, P, Hkv, _ = kp.shape
    MP = tables.shape[1]
    ctx = sum(min(int(n), MP * P) for n in sl.tolist())
    nbytes = (ctx * Hkv * D * 2 * elt + 2 * B * Hq * D * elt
              + 2 * B * Hkv * D * elt + tables.numel() * 4 + B * 4)
    flops = 4 * (ctx + B) * Hq * D
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = flops / H100_F32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def _library_call(args):
    """One PyTorch call computing the same function on a pre-gathered
    context (the gather is outside the timed call): SDPA with a boolean
    mask. A yardstick only; the port never calls it."""
    import torch
    q, kp, vp, tables, sl, kn, vn = args
    B, _, Hq, D = q.shape
    _, P, Hkv, _ = kp.shape
    MP = tables.shape[1]
    idx = tables.long()
    k = torch.cat([kp[idx].reshape(B, MP * P, Hkv, D), kn], 1)
    v = torch.cat([vp[idx].reshape(B, MP * P, Hkv, D), vn], 1)
    k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    pos = torch.arange(MP * P + 1, device=q.device)
    mask = ((pos[None, :] < sl[:, None]) | (pos[None, :] == MP * P))
    mask = mask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, k, v, attn_mask=mask,
                        enable_gqa=Hq != Hkv)


def phase_kernel() -> dict:
    import torch
    from distributedtraining_tpu_torch.ops import paged_attention as pa
    shapes = {
        "gpt2_124m_decode": dict(B=8, Hq=12, Hkv=12, D=64, P=16, MP=64,
                                 lens=[0, 15, 16, 17, 1023, 1024, 300,
                                       777]),
        "gqa_d128": dict(B=4, Hq=32, Hkv=8, D=128, P=16, MP=8,
                         lens=[0, 17, 100, 128]),
    }
    tols = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    checks = []
    for i, (name, s) in enumerate(shapes.items()):
        for dtype, tol in tols.items():
            args = _decode_case(s["B"], s["Hq"], s["Hkv"], s["D"], s["P"],
                                s["MP"], s["lens"], dtype, SEED + i)
            out = pa.paged_decode_attention(*args)
            ref = pa.paged_decode_reference(*args)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            checks.append({"shape": name, "dtype": str(dtype).split(".")[1],
                           "max_abs_err": err, "tol": tol})
            check(bool(torch.isfinite(out).all()),
                  f"paged decode kernel: non-finite output at {name} {dtype}")
            check(err <= tol, f"paged decode kernel vs plain version at "
                              f"{name} {dtype}: max abs {err} > {tol}")
    # time the main path's shape at the served dtype (bf16)
    s = shapes["gpt2_124m_decode"]
    args = _decode_case(s["B"], s["Hq"], s["Hkv"], s["D"], s["P"], s["MP"],
                        s["lens"], torch.bfloat16, SEED)
    kernel_ms = _time_ms(lambda: pa.paged_decode_attention(*args))
    plain_ms = _time_ms(lambda: pa.paged_decode_reference(*args))
    library_ms = _time_ms(_library_call(args))
    bound_ms, bound_by = _bound(args, 2)
    res = {"checks": checks, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "timed_shape": "gpt2_124m_decode bf16"}
    log("kernel phase:", json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# 4. flash
# ---------------------------------------------------------------------------

def _tokenizer():
    from distributedtraining_tpu_torch.data import datasets
    from distributedtraining_tpu_torch.models import gpt2
    docs = datasets.text_corpus(split="train", n_docs=512, seed=SEED)
    return datasets.WordTokenizer(
        docs, vocab_size=gpt2.PRESETS["gpt2-124m"].vocab_size)


def _batches(tok, *, split, batch_size, seq_len, n):
    """``n`` packed batches of the synthetic corpus (shuffled for
    training, in order for held-out eval), as numpy dicts."""
    from distributedtraining_tpu_torch.data import datasets
    docs = datasets.text_corpus(split=split, n_docs=512, seed=SEED)
    it = datasets.batch_iterator(
        docs, tok, batch_size=batch_size, seq_len=seq_len, repeat=True,
        shuffle=split == "train",
        seed=datasets.shuffle_seed_for("chip_smoke"))
    return [next(it) for _ in range(n)]


def _flash_case(B, T, H, D, seg, dtype, seed):
    """q, k, v as the model makes them (strided views of one fused
    [B, T, 3E] projection), a strided cotangent, and int32 segment ids
    (or None), all on the card."""
    import torch
    g = torch.Generator().manual_seed(seed)
    E = H * D
    qkv = torch.randn((B, T, 3 * E), generator=g).to("cuda", dtype)
    q, k, v = (x.reshape(B, T, H, D) for x in qkv.split(E, dim=-1))
    do = torch.randn((B, H, T, D), generator=g).to("cuda", dtype)
    do = do.transpose(1, 2)                       # [B, T, H, D], strided
    seg_t = None if seg is None else torch.from_numpy(
        seg[:B, :T].copy()).to("cuda", torch.int32)
    return q, k, v, do, seg_t


def _causal_pairs(B, T, H, seg) -> int:
    """(query, key) pairs the mask leaves visible: per document of n
    tokens, n (n + 1) / 2; the work this run's data needs."""
    import numpy as np
    if seg is None:
        return B * H * T * (T + 1) // 2
    total = 0
    for row in seg[:B, :T]:
        _, counts = np.unique(row, return_counts=True)
        total += int(sum(n * (n + 1) // 2 for n in counts))
    return H * total


def _flash_bounds(B, T, H, D, seg, elt) -> dict:
    """Least time per kernel: the bytes it must move (inputs read once,
    outputs written once) over the memory rate vs its products over the
    visible pairs (2 D operations each) at the bf16 tensor-core rate."""
    n = B * T * H * D * elt
    rows = B * H * T * 4                          # lse / di, f32
    segb = 0 if seg is None else B * T * 4
    flops = 2 * D * _causal_pairs(B, T, H, seg)   # one product
    work = {"flash_attention_fwd": (3 * n + segb + n + rows, 2 * flops),
            "flash_attention_bwd_dkv": (4 * n + 2 * rows + segb + 2 * n,
                                        4 * flops),
            "flash_attention_bwd_dq": (4 * n + 2 * rows + segb + n,
                                       3 * flops)}
    out = {}
    for name, (nbytes, ops) in work.items():
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = ops / H100_BF16_FLOPS * 1e3
        out[name] = ((bytes_ms, "bytes") if bytes_ms >= ops_ms
                     else (ops_ms, "operations"))
    return out


def _max_err(a, ref, scaled: bool = False) -> float:
    """Max abs difference; ``scaled`` divides each by max(1, |ref|), so a
    bf16 result is held to its rounding at any magnitude (rounding to
    bf16 moves a value by up to 2^-8 of it)."""
    diff = (a.float() - ref.float()).abs()
    if scaled:
        diff = diff / ref.float().abs().clamp(min=1.0)
    return float(diff.max())


def phase_flash(seg) -> dict:
    """Kernel vs plain version for the forward and both backward
    kernels; ``seg`` is a real packed batch's segment ids [8, 1024]."""
    import numpy as np
    import torch
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    # ids in no order (not a packer's layout): tile skipping must test
    # id ranges, not assume documents are contiguous
    scattered = np.random.default_rng(SEED).integers(0, 4, (2, 256)).astype(
        np.int32)
    cases = {
        "train_b8_t1024_h12_d64": (8, 1024, 12, 64, seg),
        "t64": (8, 64, 12, 64, seg),
        "t512": (8, 512, 12, 64, seg),
        "ragged_t777": (4, 777, 12, 64, seg),
        "d128_t300": (2, 300, 6, 128, seg),
        "unpacked_t200": (2, 200, 4, 64, None),
        "scattered_ids_t256": (2, 256, 4, 64, scattered),
    }
    tols = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
    checks = []
    for i, (name, (B, T, H, D, sg)) in enumerate(cases.items()):
        for dtype, (tol_f, tol_b) in tols.items():
            q, k, v, do, st = _flash_case(B, T, H, D, sg, dtype, SEED + i)
            o, lse = fa.flash_attention_fwd(q, k, v, st)
            di = fa._row_dot(o, do)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, st)
            dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, di, st)
            # the plain versions on the same values, unrounded (f32)
            f = [x.float() for x in (q, k, v)]
            ref_o, ref_lse = fa.flash_attention_reference(*f, st)
            ref_g = fa.flash_attention_bwd_reference(
                *f, o.float(), lse, do.float(), st)
            torch.cuda.synchronize()
            pairs = {"o": (o, ref_o), "lse": (lse, ref_lse),
                     "dq": (dq, ref_g[0]), "dk": (dk, ref_g[1]),
                     "dv": (dv, ref_g[2])}
            dt = str(dtype).split(".")[1]
            c = {"case": name, "dtype": dt,
                 "max_abs": {key: _max_err(a, r)
                             for key, (a, r) in pairs.items()},
                 "tol_fwd": tol_f, "tol_bwd": tol_b}
            # the limits apply to the abs error in f32, to the scaled one
            # in bf16
            if dtype == torch.bfloat16:
                c["max_scaled"] = {key: _max_err(a, r, scaled=True)
                                   for key, (a, r) in pairs.items()}
            checks.append(c)
            for key, err in c.get("max_scaled", c["max_abs"]).items():
                tol = tol_f if key in ("o", "lse") else tol_b
                check(err <= tol, f"flash kernel vs plain version at {name} "
                                  f"{dt}: {key} max abs {err} > {tol}")
            check(all(bool(torch.isfinite(x).all())
                      for x in (o, lse, dq, dk, dv)),
                  f"flash kernels: non-finite output at {name} {dt}")

    # timing at the training shape, bf16, contiguous cotangent
    B, T, H, D, sg = cases["train_b8_t1024_h12_d64"]
    q, k, v, do, st = _flash_case(B, T, H, D, sg, torch.bfloat16, SEED)
    do = do.contiguous()
    o, lse = fa.flash_attention_fwd(q, k, v, st)
    di = fa._row_dot(o, do)
    # the yardstick: SDPA on the same shapes, unpacked, causal
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    out_h = sdpa(qh, kh, vh, is_causal=True)
    lib_fwd = _time_ms(lambda: sdpa(qh, kh, vh, is_causal=True))
    lib_bwd = _time_ms(lambda: torch.autograd.grad(
        out_h, (qh, kh, vh), doh, retain_graph=True))
    # the plain backward computes dq, dk and dv in one call: both
    # backward kernels are set beside it
    plain_fwd = _time_ms(lambda: fa.flash_attention_reference(q, k, v, st))
    plain_bwd = _time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, st))
    runs = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, st), plain_fwd, lib_fwd),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, st),
            plain_bwd, lib_bwd),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, di, st),
            plain_bwd, lib_bwd),
    }
    bounds = _flash_bounds(B, T, H, D, sg, 2)
    timed = {name: {"ms": _time_ms(fn), "plain_ms": plain,
                    "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                    "library_ms": lib}
             for name, (fn, plain, lib) in runs.items()}
    res = {"checks": checks, "timed": timed,
           "timed_shape": "B 8, T 1024, H 12, D 64 bf16, packed segment "
                          "ids of a real batch; SDPA unpacked causal",
           "visible_pairs": _causal_pairs(B, T, H, sg),
           "all_pairs": B * H * T * (T + 1) // 2}
    log("flash phase:", json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# 4. slice (f32 parity) and 5. serve (served dtype)
# ---------------------------------------------------------------------------

def _prompts(lengths, vocab, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]


def _sharpened(tree) -> dict:
    """The same weights with dense kernels and positions scaled x10. At
    the init scale a random GPT-2 mostly repeats its last input token,
    which a broken attention could too; sharpened, the output depends
    on the context, so token identity tests the decode path."""
    import copy
    out = copy.deepcopy(tree)
    for key, block in out.items():
        if key.startswith("h_"):
            for name in ("c_attn", "c_proj", "c_fc", "mlp_proj"):
                block[name]["kernel"] *= 10.0
    out["wpe"] *= 10.0
    return out


def phase_slice_f32(tree) -> dict:
    """Engine vs reference_generate, token for token, at f32 — for the
    init-scale weights and their sharpened copy."""
    res = {"init": _parity_f32(tree, SEED + 1)}
    res["sharpened"] = _parity_f32(_sharpened(tree), SEED + 3)
    log("slice f32:", json.dumps(res))
    return res


def _parity_f32(tree, seed) -> dict:
    from distributedtraining_tpu_torch.engine.serve import (
        GenerationEngine, reference_generate)
    from distributedtraining_tpu_torch.models import gpt2
    cfg = dataclasses.replace(gpt2.PRESETS["gpt2-124m"], dtype="float32")
    model, _ = gpt2.make_model(cfg)
    state = gpt2.params_from_numpy(tree, device="cuda")
    prompts = _prompts((5, 16, 17, 200), cfg.vocab_size, seed)
    eng = GenerationEngine(model, state, device="cuda", max_slots=4,
                           page_size=16)
    try:
        t0 = time.perf_counter()
        out = eng.generate(prompts, 16)
        eng_s = time.perf_counter() - t0
    finally:
        eng.close()
    t0 = time.perf_counter()
    refs = [reference_generate(model, state, p, 16) for p in prompts]
    ref_s = time.perf_counter() - t0
    check(out == refs, f"f32 engine output differs from reference_generate:"
                       f" {out} vs {refs}")
    return {"prompts": [len(p) for p in prompts], "new_tokens": 16,
            "token_identical": True, "engine_s": eng_s, "reference_s": ref_s,
            "distinct_tokens": [len(set(o)) for o in out]}


def _post(port: int, body: dict, timeout: float = 300.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def phase_serve(tree) -> dict:
    import torch
    from distributedtraining_tpu_torch.engine.serve import (
        GenerationEngine, ServeHTTPFrontend, ServeLoop)
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.ops import paged_attention as pa
    from distributedtraining_tpu_torch.utils import obs
    cfg = gpt2.PRESETS["gpt2-124m"]           # bf16 compute, f32 weights
    model, _ = gpt2.make_model(cfg)
    state = gpt2.params_from_numpy(tree, device="cuda")
    lengths = (8, 40, 100, 200, 350, 500, 700, 900)
    prompts = _prompts(lengths, cfg.vocab_size, SEED + 2)
    n_new = 32
    eng = GenerationEngine(model, state, device="cuda", max_slots=8,
                           page_size=16, revision="seed0")
    loop = ServeLoop(eng, idle_poll_s=0.01).start()
    fe = ServeHTTPFrontend(eng, 0, timeout_s=300.0)
    port = fe.start()
    obs.configure()
    try:
        # one short request first: cuBLAS and allocator warm-up stay
        # out of the measured run
        code, warm = _post(port, {"tokens": prompts[0], "max_new_tokens": 4})
        check(code == 200 and warm["status"] == "done",
              f"warm-up request failed: {code} {warm}")
        torch.cuda.synchronize()
        obs.reset()
        obs.configure()
        torch.cuda.reset_peak_memory_stats()
        # main path: counts to 0 just before, read just after
        pa.launches = 0
        eng.decode_dispatches = 0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
            futs = [ex.submit(_post, port, {"tokens": p,
                                            "max_new_tokens": n_new})
                    for p in prompts]
            results = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        launches = pa.launches
        dispatches = eng.decode_dispatches
        peak = torch.cuda.max_memory_allocated()
        reg = obs.registry()
        pct = {name: reg.histogram(name).percentiles((50.0, 95.0))
               for name in ("serve.ttft_ms", "serve.tpot_ms",
                            "serve.step_ms", "serve.prefill_ms")}
    finally:
        fe.close()
        loop.close()
        eng.close()
        obs.reset()
    for (code, out), p in zip(results, prompts):
        check(code == 200, f"POST /generate answered {code}")
        check(out["status"] == "done", f"request not done: {out}")
        check(len(out["tokens"]) == n_new,
              f"{len(out['tokens'])} tokens for a {len(p)}-token prompt")
        check(all(0 <= t < cfg.vocab_size for t in out["tokens"]),
              "token id outside the vocabulary")
    check(dispatches > 0 and launches == cfg.n_layer * dispatches,
          f"paged decode kernel launches {launches} != n_layer "
          f"{cfg.n_layer} x decode dispatches {dispatches}")
    n_tok = n_new * len(prompts)
    res = {"model": "gpt2-124m", "dtype": cfg.dtype,
           "prompt_lens": list(lengths), "new_tokens": n_new,
           "requests": len(prompts), "all_done": True,
           "tokens_per_s": n_tok / wall, "wall_s": wall,
           "ttft_ms_p50": pct["serve.ttft_ms"]["p50"],
           "ttft_ms_p95": pct["serve.ttft_ms"]["p95"],
           "tpot_ms_p50": pct["serve.tpot_ms"]["p50"],
           "tpot_ms_p95": pct["serve.tpot_ms"]["p95"],
           "step_ms_p50": pct["serve.step_ms"]["p50"],
           "prefill_ms_p50": pct["serve.prefill_ms"]["p50"],
           "decode_dispatches": dispatches, "kernel_launches": launches,
           "peak_cuda_mem_bytes": peak}
    return res


def phase_profile(tree) -> dict:
    """Where a served decode step's time goes: torch.profiler over a
    window of steady decode steps at the serve phase's batch (8 slots,
    prompts of 8-900 tokens, all prefilled before the window). Reports
    wall and device time per step, the device's idle share, and the
    kernels that take the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from distributedtraining_tpu_torch.engine.serve import GenerationEngine
    from distributedtraining_tpu_torch.models import gpt2
    cfg = gpt2.PRESETS["gpt2-124m"]
    model, _ = gpt2.make_model(cfg)
    state = gpt2.params_from_numpy(tree, device="cuda")
    prompts = _prompts((8, 40, 100, 200, 350, 500, 700, 900),
                       cfg.vocab_size, SEED + 2)
    n_steps = 8
    eng = GenerationEngine(model, state, device="cuda", max_slots=8,
                           page_size=16)
    try:
        for p in prompts:
            eng.submit(p, 32)
        for _ in range(4):                 # admit + prefill all, warm up
            eng.step()
        check(eng.active_count == len(prompts), "profile batch not full")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        eng.close()
    kernels: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            k = kernels.setdefault(evt.name, [0.0, 0])
            k[0] += evt.time_range.elapsed_us() / 1e3
            k[1] += 1
    busy_ms = sum(v[0] for v in kernels.values())
    paged = sum(v[0] for n, v in kernels.items() if "paged_decode" in n)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    res = {"steps": n_steps, "batch": len(prompts),
           "wall_ms_per_step": wall_ms / n_steps,
           "device_ms_per_step": busy_ms / n_steps,
           "idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
           "kernels_per_step": sum(v[1] for v in kernels.values()) / n_steps,
           "paged_decode_ms_per_step": paged / n_steps,
           "top_kernels": [{"name": n[:80], "ms_per_step": v[0] / n_steps,
                            "launches_per_step": v[1] / n_steps}
                           for n, v in top]}
    log("profile:", json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# 8. train, 9. parity, 10. tprof
# ---------------------------------------------------------------------------

def _zero_counts():
    """Set the flash and fused-CE launch counts to 0."""
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    for counts in (fa.launches, fused_ce.launches):
        for key in counts:
            counts[key] = 0


def phase_train(tree, tok, fused: bool = False) -> dict:
    """The miner's path: TrainEngine.train_step on packed batches, then
    the validator's score of the delta on held-out batches; ``fused``
    takes the loss through the fused CE kernels (--fused-loss)."""
    import math
    import torch
    from distributedtraining_tpu_torch import delta
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    cfg = gpt2.PRESETS["gpt2-124m"]           # bf16 compute, f32 params
    model, _ = gpt2.make_model(cfg)
    train = _batches(tok, split="train", batch_size=TRAIN_B,
                     seq_len=TRAIN_T, n=TRAIN_STEPS)
    held_out = _batches(tok, split="test", batch_size=TRAIN_B,
                        seq_len=EVAL_T, n=EVAL_BATCHES)
    eng = TrainEngine(model, fused_loss=fused, device="cuda")
    state = eng.init_state(gpt2.params_from_numpy(tree, device="cuda"))
    base = {k: v.detach().clone() for k, v in state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # main path: counts to 0 just before, read just after
    _zero_counts()
    losses, step_ms = [], []
    t_all = time.perf_counter()
    for batch in train:
        t0 = time.perf_counter()
        state, metrics = eng.train_step(state, eng.place_batch(batch))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
    train_s = time.perf_counter() - t_all
    peak = torch.cuda.max_memory_allocated()
    d = delta.compute_delta(state.params, base)
    finite = bool(delta.tree_finite(d))
    base_loss, base_ppl = eng.evaluate(base, held_out)
    trained_loss, trained_ppl = eng.evaluate(delta.apply_delta(base, d),
                                             held_out)
    launches = {**fa.launches, **fused_ce.launches}
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses),
          f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0],
          f"training loss did not fall: {losses[0]} -> {losses[-1]}")
    check(finite, "the delta has non-finite values")
    score = base_loss - trained_loss
    check(math.isfinite(score) and score > 0,
          f"validator score base - trained = {score} is not > 0 "
          f"({base_loss} vs {trained_loss})")
    n_fwd = cfg.n_layer * (TRAIN_STEPS + 2 * EVAL_BATCHES)
    n_bwd = cfg.n_layer * TRAIN_STEPS
    check(launches["flash_attention_fwd"] == n_fwd,
          f"flash forward launches {launches['flash_attention_fwd']} != "
          f"{n_fwd} = 12 x (steps + eval batches)")
    for key in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        check(launches[key] == n_bwd,
              f"{key} launches {launches[key]} != {n_bwd} = 12 x steps")
    ce = {"fused_ce_fwd": TRAIN_STEPS + 2 * EVAL_BATCHES if fused else 0,
          "fused_ce_bwd_dh": TRAIN_STEPS if fused else 0,
          "fused_ce_bwd_dw": TRAIN_STEPS if fused else 0}
    for key, n in ce.items():
        check(launches[key] == n, f"{key} launches {launches[key]} != {n}")
    p50 = statistics.median(step_ms)
    res = {"model": "gpt2-124m", "dtype": cfg.dtype, "batch": TRAIN_B,
           "fused_loss": fused,
           "seq_len": TRAIN_T, "steps": TRAIN_STEPS, "losses": losses,
           "step_ms_p50": p50, "step_ms_first": step_ms[0],
           "tokens_per_s": TRAIN_B * TRAIN_T / p50 * 1e3,
           "train_s": train_s, "peak_cuda_mem_bytes": peak,
           "eval_seq_len": EVAL_T, "eval_batches": EVAL_BATCHES,
           "base_loss": base_loss, "trained_loss": trained_loss,
           "base_ppl": base_ppl, "trained_ppl": trained_ppl,
           "score": score, "delta_finite": finite, "launches": launches}
    log("train fused:" if fused else "train:", json.dumps(res))
    return res


def phase_train_parity(tree, tok) -> dict:
    """Three f32 steps through the kernels vs the same three steps with
    attention forced to the plain versions. The forcing is a test hook
    here (patching the module's dispatch); the package has no switch."""
    from unittest import mock
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    cfg = dataclasses.replace(gpt2.PRESETS["gpt2-124m"], dtype="float32")
    model, _ = gpt2.make_model(cfg)
    batches = _batches(tok, split="train", batch_size=2, seq_len=256, n=3)

    def run():
        eng = TrainEngine(model, device="cuda")
        state = eng.init_state(gpt2.params_from_numpy(tree, device="cuda"))
        before = dict(fa.launches)
        losses = [float(eng.train_step(state, eng.place_batch(b))[1]["loss"])
                  for b in batches]
        return losses, {k: fa.launches[k] - before[k] for k in before}

    kernel_losses, kernel_launches = run()
    with mock.patch.object(fa, "_forward",
                           fa.flash_attention_reference), \
            mock.patch.object(fa, "_backward",
                              fa.flash_attention_bwd_reference):
        plain_losses, plain_launches = run()
    check(all(n == cfg.n_layer * len(batches)
              for n in kernel_launches.values()),
          f"kernel run launches {kernel_launches}")
    check(not any(plain_launches.values()),
          f"plain run launched kernels: {plain_launches}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(kernel_losses,
                                                  plain_losses))
    check(rel <= 1e-4, f"f32 training through the kernels vs the plain "
                       f"attention: losses {kernel_losses} vs "
                       f"{plain_losses} (max rel {rel} > 1e-4)")
    res = {"dtype": "float32", "batch": 2, "seq_len": 256,
           "kernel_losses": kernel_losses, "plain_losses": plain_losses,
           "max_rel_diff": rel}
    log("train parity:", json.dumps(res))
    return res


def phase_train_profile(tree, tok, fused: bool = False) -> dict:
    """Where a train step's time goes: torch.profiler over steady steps
    at the train phase's shape (``fused``: with --fused-loss)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.models import gpt2
    cfg = gpt2.PRESETS["gpt2-124m"]
    model, _ = gpt2.make_model(cfg)
    n_steps = 3
    batches = _batches(tok, split="train", batch_size=TRAIN_B,
                       seq_len=TRAIN_T, n=2 + n_steps)
    eng = TrainEngine(model, fused_loss=fused, device="cuda")
    state = eng.init_state(gpt2.params_from_numpy(tree, device="cuda"))
    placed = [eng.place_batch(b) for b in batches]
    for b in placed[:2]:                       # warm up
        eng.train_step(state, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in placed[2:]:
            eng.train_step(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            k = kernels.setdefault(evt.name, [0.0, 0])
            k[0] += evt.time_range.elapsed_us() / 1e3
            k[1] += 1
    busy_ms = sum(v[0] for v in kernels.values())
    flash = {name: sum(v[0] for n, v in kernels.items() if name in n)
             / n_steps for name in ("flash_fwd", "flash_bwd_dkv",
                                    "flash_bwd_dq")}
    ce = {name: sum(v[0] for n, v in kernels.items() if name in n)
          / n_steps for name in ("ce_fwd", "ce_dh", "ce_dw")}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    res = {"steps": n_steps, "batch": TRAIN_B, "seq_len": TRAIN_T,
           "fused_loss": fused, "ce_ms_per_step": ce,
           "wall_ms_per_step": wall_ms / n_steps,
           "device_ms_per_step": busy_ms / n_steps,
           "idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
           "kernels_per_step": sum(v[1] for v in kernels.values()) / n_steps,
           "flash_ms_per_step": flash,
           "top_kernels": [{"name": n[:80], "ms_per_step": v[0] / n_steps,
                            "launches_per_step": v[1] / n_steps}
                           for n, v in top]}
    check(kernels, "the train-step profile saw no device time")
    log("train fused profile:" if fused else "train profile:",
        json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# 11. ce, 13. fparity, 14. miner
# ---------------------------------------------------------------------------

CE_SOURCE = "distributedtraining_tpu_torch/csrc/fused_ce.cu"
CE_TPU_KERNELS = {   # name: (file:line of the Pallas kernel, its call)
    "fused_ce_fwd": ("distributedtraining_tpu/ops/pallas_ce.py:74",
                     "_fwd_kernel via _fwd_call (pallas_call :178)"),
    "fused_ce_bwd_dh": ("distributedtraining_tpu/ops/pallas_ce.py:124",
                        "_dh_kernel via _bwd_calls (pallas_call :201)"),
    "fused_ce_bwd_dw": ("distributedtraining_tpu/ops/pallas_ce.py:143",
                        "_dw_kernel via _bwd_calls (pallas_call :220)"),
}
CE_OUTPUTS = {"fused_ce_fwd": ("loss", "m", "s"),
              "fused_ce_bwd_dh": ("dh",), "fused_ce_bwd_dw": ("dw",)}
MINER_B, MINER_T, MINER_STEPS = 8, 64, 12
README_MINER_FLAGS = [
    "--backend", "local", "--model", "gpt2-124m", "--dataset", "synthetic",
    "--tokenizer", "word", "--fused-loss", "--no-base-wire-v2",
    "--checkpoint-interval", "0", "--no-anomaly-trace", "--flight-events",
    "0"]


def _ce_inputs(N, V, E, dtype, seed, *, labels=None, mask=None,
               label_last=False):
    """h (hidden, ``dtype``), the head rounded to h's dtype (as the
    autograd Function rounds the f32 ``wte``), int32 labels and the
    per-token upstream gradient ``g = mask / max(sum(mask), 1)``, on the
    card."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn((N, E), generator=gen).to("cuda", dtype)
    w = (torch.randn((V, E), generator=gen) * 0.02).to("cuda", dtype)
    if labels is None:
        labels = torch.randint(0, V, (N,), generator=gen)
    y = torch.as_tensor(labels).reshape(-1).to("cuda", torch.int32)
    if label_last:
        y[::3] = V - 1
    m = (torch.ones(N) if mask is None
         else torch.as_tensor(mask).reshape(-1).float()).to("cuda")
    g = (m / m.sum().clamp(min=1.0)).contiguous()
    return h, w, y.contiguous(), g


def _ce_run(h, w, y, g, fwd_only: bool = False):
    """The three kernels (the forward alone with ``fwd_only``), then the
    plain versions on the same values in f32 (the bf16 limit is held
    against that unrounded result)."""
    import torch
    from distributedtraining_tpu_torch.ops import fused_ce
    loss, m, s = fused_ce.fused_ce_fwd(h, w, y)
    hf, wf = h.float(), w.float()
    r_loss, r_m, r_s = fused_ce.fused_ce_fwd_reference(hf, wf, y)
    outs = {"loss": (loss, r_loss), "m": (m, r_m), "s": (s, r_s)}
    if not fwd_only:
        dh = fused_ce.fused_ce_bwd_dh(h, w, y, m, s, g)
        dw = fused_ce.fused_ce_bwd_dw(h, w, y, m, s, g)
        r_dh, r_dw = fused_ce.fused_ce_bwd_reference(hf, wf, y, r_m, r_s, g)
        outs.update(dh=(dh, r_dh), dw=(dw, r_dw))
    torch.cuda.synchronize()
    return outs


def _ce_bounds(N, V, E, elt=2) -> dict:
    """Least time per kernel: inputs read once and outputs written once
    over the memory rate vs 2 N V E operations per product (the forward
    one, dh and dW a recompute each plus their own) at the bf16 rate."""
    h, w, row = N * E * elt, V * E * elt, N * 4
    work = {"fused_ce_fwd": (h + w + row + 3 * row, 2 * N * V * E),
            "fused_ce_bwd_dh": (h + w + 4 * row + h, 4 * N * V * E),
            "fused_ce_bwd_dw": (h + w + 4 * row + V * E * 4, 4 * N * V * E)}
    out = {}
    for name, (nbytes, ops) in work.items():
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = ops / H100_BF16_FLOPS * 1e3
        out[name] = ((bytes_ms, "bytes") if bytes_ms >= ops_ms
                     else (ops_ms, "operations"))
    return out


CE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _ce_limit_errors(outs: dict, dtype: str) -> dict:
    """Per output ``(max |kernel - plain|, the error its limit applies
    to)``. f32: over max(1, max |plain|), as for the other kernels. bf16:
    over max |plain| alone, so gradients far below 1 are held to their
    rounding (an absolute 2e-2 would pass a zero dh); an exactly-zero
    plain output (an all-zero mask's gradients) must be exactly zero."""
    res = {}
    for k, (a, r) in outs.items():
        d = float((a.float() - r.float()).abs().max())
        ref = float(r.float().abs().max())
        if dtype == "float32":
            res[k] = (d, d / max(1.0, ref))
        else:
            res[k] = (d, d / ref if ref > 0 else
                      (0.0 if d == 0 else float("inf")))
    return res


def _ce_check(name: str, outs: dict, dtype: str) -> dict:
    """Hold each output of one case to its limit (``dtype`` is the
    kernels' input dtype), then check that the limit rejects a planted
    wrong dh and dW: zeroed and negated, or ones where the plain one is
    exactly zero. Returns ``{output: (abs error, limit error)}``."""
    errs = _ce_limit_errors(outs, dtype)
    tol = CE_TOL[dtype]
    for k, (_, err) in errs.items():
        check(err <= tol, f"fused CE kernel vs plain version at {name} "
                          f"{dtype}: {k} error {err} > {tol}")
    for k in ("dh", "dw"):
        if k not in outs:
            continue
        ref = outs[k][1]
        planted = ((ref * 0, -ref) if bool(ref.any()) else (ref * 0 + 1,))
        for bad in planted:
            _, err = _ce_limit_errors({k: (bad, ref)}, dtype)[k]
            check(not err <= tol, f"the {dtype} limit passes a planted wrong "
                                  f"{k} at {name} (error {err})")
    return errs


def phase_ce(batch) -> dict:
    """Kernel vs plain version for the fused CE forward, dh and dW;
    ``batch`` is a real packed training batch [8, 1024] (its labels and
    loss mask set the training-shape case)."""
    import torch
    from distributedtraining_tpu_torch.ops import fused_ce
    V, E = 50304, 768
    ids, mask = batch["input_ids"][:, 1:], batch["loss_mask"][:, 1:]
    N = ids.size
    bf, f32 = torch.bfloat16, torch.float32
    cases = {
        "train_n8184_bf16": (N, V, E, bf, dict(labels=ids, mask=mask)),
        "miner_n504_bf16": (504, V, E, bf, {}),
        "ragged_n777_bf16": (777, V, E, bf, {}),
        "vocab1000_label_last_bf16": (300, 1000, E, bf,
                                      dict(label_last=True)),
        "zero_mask_bf16": (300, 1000, E, bf, dict(mask=[0.0] * 300)),
        "small_f32": (70, 300, 64, f32, dict(label_last=True)),
        "miner_n504_f32": (504, V, E, f32, {}),
        # 135 row tiles: one vocab split, outputs written by the kernels
        # themselves
        "one_split_n4300_f32": (4300, 1000, 128, f32, {}),
        # GPT-2-774M's width: the K-chunked forward alone (dh and dW take
        # bf16 E <= 1024)
        "fwd_e1280_bf16": (300, 3000, 1280, bf, {}),
        # 1024 row tiles: one forward split
        "fwd_one_split_n131072_bf16": (131072, 300, 64, bf, {}),
    }
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    checks = []
    for i, (name, (n, v, e, dtype, kw)) in enumerate(cases.items()):
        h, w, y, g = _ce_inputs(n, v, e, dtype, SEED + i, **kw)
        splits = {"fwd": (fused_ce._fwd_splits(n, v, sms) if dtype == bf
                          else fused_ce._splits(h, v)),
                  "dh": fused_ce._splits(h, v)}
        outs = _ce_run(h, w, y, g, fwd_only=name.startswith("fwd_"))
        dt = str(dtype).split(".")[1]
        check(all(bool(torch.isfinite(a.float()).all())
                  for a, _ in outs.values()),
              f"fused CE kernels: non-finite output at {name}")
        errs = _ce_check(name, outs, dt)
        checks.append({"case": name, "dtype": dt, "N": n, "V": v, "E": e,
                       "splits": splits,
                       "max_abs": {k: d for k, (d, _) in errs.items()},
                       "err": {k: x for k, (_, x) in errs.items()},
                       "tol": CE_TOL[dt]})
        if name == "zero_mask_bf16":
            check(not outs["dh"][0].any() and not outs["dw"][0].any(),
                  "an all-zero mask must give zero gradients")
        del outs, h, w
    timed = {}
    for n, seed in ((N, SEED), (504, SEED + 1)):
        h, w, y, g = _ce_inputs(n, V, E, bf, seed)
        loss, m, s = fused_ce.fused_ce_fwd(h, w, y)
        runs = {"fused_ce_fwd": lambda: fused_ce.fused_ce_fwd(h, w, y),
                "fused_ce_bwd_dh": lambda: fused_ce.fused_ce_bwd_dh(
                    h, w, y, m, s, g),
                "fused_ce_bwd_dw": lambda: fused_ce.fused_ce_bwd_dw(
                    h, w, y, m, s, g)}
        plain_fwd = _time_ms(lambda: fused_ce.fused_ce_fwd_reference(h, w, y))
        plain_bwd = _time_ms(lambda: fused_ce.fused_ce_bwd_reference(
            h, w, y, m, s, g))
        # the materialised path: two library calls (a cuBLAS bf16 GEMM to
        # the logits, cast to f32, and F.cross_entropy), and its backward
        hh, ww = h.detach().requires_grad_(), w.detach().requires_grad_()
        ce = torch.nn.functional.cross_entropy

        def lib_fwd():
            return ce((hh @ ww.T).float(), y.long(), reduction="none")

        out = lib_fwd()
        lib_f = _time_ms(lib_fwd)
        lib_b = _time_ms(lambda: torch.autograd.grad(out, (hh, ww), g,
                                                     retain_graph=True))
        del out
        bounds = _ce_bounds(n, V, E)
        for name, fn in runs.items():
            timed.setdefault(name, {})[f"n{n}"] = {
                "ms": _time_ms(fn),
                "splits": (fused_ce._fwd_splits(n, V, sms)
                           if name == "fused_ce_fwd"
                           else fused_ce._splits(h, V)),
                "plain_ms": plain_fwd if name == "fused_ce_fwd" else plain_bwd,
                "library_ms": lib_f if name == "fused_ce_fwd" else lib_b,
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
        if n == 504:
            # the same forward and dh with the vocab split forced to 1 (a
            # test hook that patches the wrappers' choices): what the
            # split grids buy at the miner's shape
            auto = fused_ce._splits, fused_ce._fwd_splits
            fused_ce._splits = lambda h, V: 1
            fused_ce._fwd_splits = lambda N, V, sms: 1
            try:
                for name in ("fused_ce_fwd", "fused_ce_bwd_dh"):
                    timed[name]["n504"]["ms_one_split"] = _time_ms(runs[name])
            finally:
                fused_ce._splits, fused_ce._fwd_splits = auto
        del h, w, hh, ww
        torch.cuda.empty_cache()
    res = {"checks": checks, "timed": timed,
           "timed_shape": f"N {N} and 504, V {V}, E {E}, bf16 h and head",
           "library": "two library calls: cuBLAS bf16 GEMM to the logits "
                      "(cast to f32) + F.cross_entropy; backward: its "
                      "autograd (dh and dW in one call)",
           "plain": "the plain backward computes dh and dW in one call"}
    log("ce phase:", json.dumps(res))
    return res


def phase_fused_parity(tree, tok) -> dict:
    """Three f32 steps with the loss through the fused CE kernels (f32
    FMA) vs the same three with the materialised f32 head."""
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.ops import fused_ce
    cfg = dataclasses.replace(gpt2.PRESETS["gpt2-124m"], dtype="float32")
    model, _ = gpt2.make_model(cfg)
    batches = _batches(tok, split="train", batch_size=2, seq_len=256, n=3)

    def run(fused):
        eng = TrainEngine(model, fused_loss=fused, device="cuda")
        state = eng.init_state(gpt2.params_from_numpy(tree, device="cuda"))
        before = dict(fused_ce.launches)
        losses = [float(eng.train_step(state, eng.place_batch(b))[1]["loss"])
                  for b in batches]
        return losses, {k: fused_ce.launches[k] - before[k] for k in before}

    fused_losses, fused_launches = run(True)
    plain_losses, plain_launches = run(False)
    check(all(n == len(batches) for n in fused_launches.values()),
          f"fused run launches {fused_launches}")
    check(not any(plain_launches.values()),
          f"unfused run launched CE kernels: {plain_launches}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(fused_losses,
                                                  plain_losses))
    check(rel <= 1e-4, f"f32 training with the fused CE vs the unfused "
                       f"loss: {fused_losses} vs {plain_losses} (max rel "
                       f"{rel} > 1e-4)")
    res = {"dtype": "float32", "batch": 2, "seq_len": 256,
           "fused_losses": fused_losses, "unfused_losses": plain_losses,
           "max_rel_diff": rel}
    log("fused parity:", json.dumps(res))
    return res


def phase_miner(tree, tok) -> dict:
    """The port's miner at GPT-2-124M full width with --fused-loss: the
    MinerLoop over a local transport on a FakeClock, then the CLI entry
    point."""
    import math
    import tempfile
    import numpy as np
    import torch
    from distributedtraining_tpu_torch import serialization as ser
    from distributedtraining_tpu_torch.engine.scheduler import FakeClock
    from distributedtraining_tpu_torch.engine.train import (MinerLoop,
                                                            TrainEngine)
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.neurons import miner as miner_cli
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    cfg = gpt2.PRESETS["gpt2-124m"]
    model, _ = gpt2.make_model(cfg)
    eng = TrainEngine(model, fused_loss=True, device="cuda")
    train = _batches(tok, split="train", batch_size=MINER_B,
                     seq_len=MINER_T, n=MINER_STEPS)
    held = _batches(tok, split="test", batch_size=MINER_B, seq_len=EVAL_T,
                    n=6)
    guard_batches, score_batches = held[:2], held[2:]
    second_base = gpt2.init_params_numpy(cfg, SEED + 1)
    evals = []

    def val_batches():
        for b in guard_batches:
            evals.append(1)
            yield b

    with tempfile.TemporaryDirectory() as tmp:
        t = LocalFSTransport(os.path.join(tmp, "artifacts"))
        rev0 = t.publish_base(tree)
        loop = MinerLoop(eng, t, "chip_smoke_miner", clock=FakeClock(),
                         send_interval=4.0, check_update_interval=3.0,
                         val_batches=val_batches, val_guard_interval=4.0,
                         push_async=True)
        revs = {}

        def schedule():
            for i, b in enumerate(train):
                if i == MINER_STEPS // 2:
                    revs["second"] = t.publish_base(second_base)
                loop.clock.sleep(1.0)
                yield b

        torch.cuda.synchronize()
        # main path: counts to 0 just before, read just after
        _zero_counts()
        t0 = time.perf_counter()
        loop.bootstrap()
        check(loop._base_revision == rev0, "bootstrap did not pull the "
                                           "published base")
        report = loop.run(schedule(), max_steps=MINER_STEPS)
        loop.flush()
        loop.close()
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        launches = {**fa.launches, **fused_ce.launches}
        opt_count = loop.state.opt_state.count
        steps, n_eval = report.steps, len(evals)
        check(report.base_pulls == 1 and loop._base_revision ==
              revs["second"], f"base pulls {report.base_pulls}")
        check(report.pushes >= 2 and report.pushes_failed == 0,
              f"pushes {report.pushes}, failed {report.pushes_failed}")
        want = {"fused_ce_fwd": steps + n_eval, "fused_ce_bwd_dh": steps,
                "fused_ce_bwd_dw": steps,
                "flash_attention_fwd": cfg.n_layer * (steps + n_eval),
                "flash_attention_bwd_dkv": cfg.n_layer * steps,
                "flash_attention_bwd_dq": cfg.n_layer * steps}
        for key, n in want.items():
            check(n > 0 and launches[key] == n,
                  f"miner: {key} launches {launches[key]} != {n}")
        data = t.fetch_delta_bytes("chip_smoke_miner")
        check(data is not None, "no delta artifact on the transport")
        d = ser.from_msgpack(data, loop._wire_template())
        finite = all(bool(np.isfinite(np.asarray(v)).all())
                     for v in _leaves(d))
        check(finite, "the published delta has non-finite values")
        meta = t.fetch_delta_meta("chip_smoke_miner")
        check(meta is not None and meta.get("base_revision") ==
              revs["second"], f"rider {meta} does not name the pulled base")
        base = gpt2.params_from_numpy(second_base, device="cuda")
        dstate = gpt2.params_from_numpy(d, device="cuda")
        base_loss, _ = eng.evaluate(base, score_batches)
        trained_loss, _ = eng.evaluate(
            {k: base[k] + dstate[k] for k in base}, score_batches)
        score = base_loss - trained_loss
        check(math.isfinite(score) and score > 0,
              f"held-out score of base + delta {score} is not > 0")
        artifact_bytes = len(data)
    with tempfile.TemporaryDirectory() as work:
        _zero_counts()
        t0 = time.perf_counter()
        rc = miner_cli.main(README_MINER_FLAGS + ["--work-dir", work,
                                                  "--max-steps", "3"])
        cli_s = time.perf_counter() - t0
        cli_launches = dict(fused_ce.launches)
        path = os.path.join(work, "artifacts", "deltas", "hotkey_0.msgpack")
        check(rc == 0 and os.path.exists(path) and
              os.path.getsize(path) > 0,
              f"neurons.miner.main exited {rc} without a pushed delta")
        check(cli_launches["fused_ce_bwd_dh"] == 3,
              f"the CLI miner's fused CE launches {cli_launches}")
    res = {"model": "gpt2-124m", "fused_loss": True, "batch": MINER_B,
           "seq_len": MINER_T, "steps": steps, "guard_eval_batches": n_eval,
           "pushes": report.pushes, "base_pulls": report.base_pulls,
           "optimizer_steps_since_pull": opt_count,
           "last_loss": report.last_loss, "base_loss": base_loss,
           "trained_loss": trained_loss, "score": score,
           "artifact_bytes": artifact_bytes, "loop_s": loop_s,
           "launches": launches, "cli": {"argv": README_MINER_FLAGS
                                         + ["--max-steps", "3"],
                                         "s": cli_s,
                                         "launches": cli_launches}}
    log("miner:", json.dumps(res))
    return res


def _leaves(tree):
    """The leaves of a nested host tree as numpy arrays."""
    import torch
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v.float().numpy() if isinstance(v, torch.Tensor) else v


# ---------------------------------------------------------------------------
# 15. scatter, 16. averager
# ---------------------------------------------------------------------------

SCATTER_SOURCE = "distributedtraining_tpu_torch/csrc/dequant_scatter.cu"
SCATTER_TPU = ("distributedtraining_tpu/ops/dequant_scatter.py:68",
               "_scatter_kernel via _build_call (:85, pallas_call :86)")
AVG_MINER_STEPS = 4
AVG_EVAL_BATCHES = 4
README_AVERAGER_FLAGS = [
    "--backend", "local", "--model", "gpt2-124m", "--dataset", "synthetic",
    "--tokenizer", "word", "--strategy", "weighted", "--no-base-wire-v2",
    "--no-lineage", "--flight-events", "0"]


def _scatter_case(n, k, mode, int8, seed):
    """A CPU accumulator [n] and an entry (idx [k] int32, q int8/f32):
    unique, random-duplicate (from a quarter of n) or all-equal
    indices."""
    import torch
    g = torch.Generator().manual_seed(seed)
    acc = torch.randn(n, generator=g) * 0.01
    if mode == "unique":
        idx = torch.randperm(n, generator=g)[:k]
    elif mode == "dups":
        idx = torch.randint(0, max(1, n // 4), (k,), generator=g)
    else:
        idx = torch.full((k,), n // 3)
    q = (torch.randint(-127, 128, (k,), generator=g, dtype=torch.int8)
         if int8 else torch.randn(k, generator=g))
    return acc, idx.to(torch.int32), q


def _scatter_err(out, ref) -> float:
    return float((out.float().cpu() - ref.float().cpu()).abs().max())


def _scatter_check(name: str, out, ref) -> float:
    """The limit: bit-exact, max |kernel - plain| = 0 (the same two
    rounded operations in the same order)."""
    err = _scatter_err(out, ref)
    check(err == 0.0, f"dequant-scatter kernel vs plain version at {name}: "
                      f"max abs {err} != 0")
    return err


def _scatter_planted(acc0, idx, q, sw):
    """Plain results of two wrong kernels on the same inputs: one entry
    dropped, and one entry's value negated (an entry whose q is nonzero).
    The check must reject both."""
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    import torch
    j = int((q != 0).nonzero()[0])
    keep = torch.ones(idx.numel(), dtype=torch.bool)
    keep[j] = False
    dropped = dsc.dequant_scatter_add_plain(acc0.clone(), idx[keep], q[keep],
                                            sw)
    neg = q.clone()
    neg[j] = -neg[j]
    negated = dsc.dequant_scatter_add_plain(acc0.clone(), idx, neg, sw)
    return {"dropped": dropped, "negated": negated}


def _contribution(seed):
    """One GPT-2-124M wire-v2 contribution at the miner's defaults
    (density 1/64, int8), packed on the card from a random delta: its
    indexed leaves as (state-dict key, idx, q, sw) on the card."""
    import torch
    from distributedtraining_tpu_torch import delta
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    model, _ = gpt2.make_model(gpt2.PRESETS["gpt2-124m"])
    g = torch.Generator(device=DEV).manual_seed(seed)
    d = {k: torch.randn(v.shape, generator=g, device=DEV) * 1e-3
         for k, v in model.state_dict().items()}
    packed, _ = delta.pack_delta_v2(d, density=1.0 / 64.0, quant="int8")
    leaves = []
    for key, e in delta._packed_entries(packed["leaves"]):
        if e["idx"].numel():
            leaves.append((key, e["idx"], e["q"],
                           dsc.fold_weight(0.37, float(e["scale"]))))
    return {k: v.shape for k, v in d.items()}, leaves


def _scatter_bound(entries) -> tuple[float, str]:
    """Least time: idx and q read once and one accumulator word read and
    written (8 B) per entry over the memory rate, vs a multiply and an
    add per entry at the f32 rate."""
    nbytes = sum(idx.numel() * (4 + q.element_size() + 8)
                 for idx, q in entries)
    ops = sum(2 * idx.numel() for idx, _ in entries)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def phase_scatter() -> dict:
    """Kernel vs plain version for the dequantize-scatter-add (the plain
    one on CPU copies, where index_add_ adds in index order): bit-exact,
    and the check must reject planted wrong results; then timing."""
    import torch
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    cases = {
        "unique_int8": (1 << 20, 16384, "unique", True),
        "unique_f32": (1 << 20, 16384, "unique", False),
        "dups_int8": (200000, 60000, "dups", True),
        "dups_f32": (200000, 60000, "dups", False),
        "alldup_int8": (65536, 20000, "alldup", True),
        "alldup_f32": (65536, 20000, "alldup", False),
        "k1": (100000, 1, "unique", True),
        # wte's n (50304 x 768 > 2^24 elements) at its k, with duplicates
        "wte_n_dups_int8": (38633472, 603648, "dups", True),
    }
    checks = []
    for i, (name, (n, k, mode, int8)) in enumerate(cases.items()):
        acc0, idx, q = _scatter_case(n, k, mode, int8, SEED + i)
        sw = dsc.fold_weight(0.37, 0.0123)
        ref = dsc.dequant_scatter_add_plain(acc0.clone(), idx, q, sw)
        out = dsc.dequant_scatter_kernel(acc0.to(DEV, copy=True),
                                         idx.to(DEV), q.to(DEV), sw)
        torch.cuda.synchronize()
        err = _scatter_check(name, out, ref)
        planted = {}
        for what, bad in _scatter_planted(acc0, idx, q, sw).items():
            planted[what] = _scatter_err(bad, out)
            check(planted[what] > 0, f"the scatter check passes a planted "
                                     f"wrong result ({what}) at {name}")
        checks.append({"case": name, "n": n, "k": k, "mode": mode,
                       "q": "int8" if int8 else "float32",
                       "max_abs_err": err, "planted_err": planted})
    # the main path's shapes: one whole GPT-2-124M contribution, folded
    # in one call of the contribution entry; then the same contribution
    # with one leaf made hostile (every other index repeats its
    # neighbour), so that one launch runs the ordered path for that leaf
    # and the plain read-modify-writes for the others
    shapes, leaves = _contribution(SEED)
    hostile = [(key, idx.clone(), q, sw) for key, idx, q, sw in leaves]
    hkey, hidx = hostile[len(hostile) // 2][:2]
    hidx[1::2] = hidx[0::2][:hidx[1::2].numel()]
    for case, part in (("contribution_gpt2_124m", leaves),
                       ("contribution_one_hostile_leaf", hostile)):
        acc = {key: torch.randn(shapes[key], device=DEV) * 0.01
               for key, _, _, _ in part}
        acc_cpu = {k: v.cpu().clone() for k, v in acc.items()}
        c = dsc.stage_contribution([(acc[key].view(-1), idx.cpu(), q.cpu(),
                                     sw) for key, idx, q, sw in part])
        before = dsc.launches
        dsc.dequant_scatter_contribution(c)
        check(dsc.launches == before + 1,
              f"{case}: {dsc.launches - before} launches, not 1")
        for key, idx, q, sw in part:
            dsc.dequant_scatter_add_plain(acc_cpu[key].view(-1), idx.cpu(),
                                          q.cpu(), sw)
        torch.cuda.synchronize()
        err = max(_scatter_check(f"{case}:{key}", acc[key], acc_cpu[key])
                  for key, _, _, _ in part)
        checks.append({"case": case, "leaves": len(part),
                       "k": sum(idx.numel() for _, idx, _, _ in part),
                       "duplicates_in": hkey if part is hostile else None,
                       "max_abs_err": err})
    # timing, L2 flushed, median of 30: the wte leaf and the contribution,
    # each staged once (onto the last case's accumulators) and folded by
    # one call of the contribution entry
    wte = [x for x in leaves if x[0] == "wte"]
    timed = {}
    for label, part in (("wte", wte), ("contribution", leaves)):
        flat = {key: acc[key].view(-1) for key, _, _, _ in part}
        c = dsc.stage_contribution([(flat[key], idx.cpu(), q.cpu(), sw)
                                    for key, idx, q, sw in part])
        lib_in = [(flat[key], idx.long(), q.float(), sw)
                  for key, idx, q, sw in part]

        def run_library(lib_in=lib_in):
            for a, il, qf, sw in lib_in:
                a.index_add_(0, il, qf, alpha=sw)

        bound_ms, bound_by = _scatter_bound([(idx, q)
                                             for _, idx, q, _ in part])
        timed[label] = {
            "ms": _time_ms(lambda c=c: dsc.dequant_scatter_contribution(c)),
            "host_ms": _host_ms(
                lambda c=c: dsc.dequant_scatter_contribution(c)),
            "plain_ms": _time_ms(
                lambda c=c: dsc.dequant_scatter_contribution_plain(c)),
            "library_ms": _time_ms(run_library), "bound_ms": bound_ms,
            "bound_by": bound_by, "leaves": len(part),
            "k": sum(idx.numel() for _, idx, _, _ in part)}
    res = {"checks": checks, "timed": timed,
           "timed_shape": "GPT-2-124M wire-v2 contribution (density 1/64, "
                          "int8), one call of the contribution entry: wte "
                          "leaf n 38633472 k 603648; all 50 indexed leaves, "
                          "k 1943040",
           "library": "index_add_(alpha=sw) on pre-converted f32 values "
                      "and int64 indices, one call a leaf",
           "bound_note": "4-byte updates at random positions move 32-byte "
                         "sectors: the memory system carries up to 8x the "
                         "bound's accumulator bytes"}
    log("scatter phase:", json.dumps(res))
    return res


def _timed_calls(obj, name: str, secs: dict, keep: dict | None = None):
    """Wrap ``obj.name`` so that each call's wall time, between two
    device synchronisations, adds to ``secs[name]`` (and its result is
    kept in ``keep[name]``): a measuring hook of this script."""
    import torch
    fn = getattr(obj, name)

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        if keep is not None:
            keep[name] = out
        return out

    setattr(obj, name, wrapper)


def _publish_packed(t, hotkey, d, rev, quant):
    """A miner that is not a MinerLoop: pack_delta_v2 of ``d`` published
    through DeltaPublisher(wire_spec=...) with its rider."""
    from distributedtraining_tpu_torch import delta
    packed, _ = delta.pack_delta_v2(d, density=1.0 / 64.0, quant=quant)
    return _publish_tree(t, hotkey, packed, rev, quant)


def _publish_tree(t, hotkey, packed, rev, quant):
    from distributedtraining_tpu_torch.engine.publish import DeltaPublisher
    from distributedtraining_tpu_torch.engine.train import MinerReport
    pub = DeltaPublisher(t, hotkey, report=MinerReport(),
                         wire_spec={"format": 2, "density": 1.0 / 64.0,
                                    "quant": quant})
    ok = pub.publish_now(packed, None, rev, f"{hotkey}-000001")
    pub.close()
    check(ok, f"publishing {hotkey}'s packed delta failed")


def _merge_profile(loop, deltas, ids) -> dict:
    """torch.profiler over one more merge of the round's submissions:
    device time by kernel (the scatter kernels and the host-to-device
    copies of idx/q apart), wall, idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.strategy.merge(loop.engine, loop.base_params, deltas, ids)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            k = by.setdefault(evt.name, [0.0, 0])
            k[0] += evt.time_range.elapsed_us() / 1e3
            k[1] += 1
    busy = sum(v[0] for v in by.values())
    check(by, "the merge profile saw no device time")
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "scatter_kernels_ms": sum(v[0] for n, v in by.items()
                                      if n.startswith("dsc_")
                                      or "dsc_" in n),
            "h2d_copy_ms": sum(v[0] for n, v in by.items()
                               if "HtoD" in n or "Memcpy" in n),
            "h2d_copies": sum(v[1] for n, v in by.items()
                              if "HtoD" in n or "Memcpy" in n),
            "top": [{"name": n[:60], "ms": v[0], "calls": v[1]}
                    for n, v in top]}


def phase_averager(tree, tok) -> dict:
    """The port's averager round at GPT-2-124M full width and depth over
    a LocalFSTransport and a LocalChain in a temporary directory: genesis,
    a MinerLoop --wire-v2 miner, packed int8 and f32 miners, a dense v1
    miner, two hostile ones, weights set through the chain; two rounds,
    then ``neurons.averager.main`` over the same root."""
    import tempfile
    import numpy as np
    import torch
    from distributedtraining_tpu_torch import delta
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.average import (AveragerLoop,
                                                              WeightedAverage)
    from distributedtraining_tpu_torch.engine.scheduler import FakeClock
    from distributedtraining_tpu_torch.engine.train import (MinerLoop,
                                                            TrainEngine)
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.neurons import averager as avg_cli
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    from distributedtraining_tpu_torch.utils import obs
    cfg = gpt2.PRESETS["gpt2-124m"]
    held = _batches(tok, split="test", batch_size=MINER_B, seq_len=EVAL_T,
                    n=AVG_EVAL_BATCHES)
    train = _batches(tok, split="train", batch_size=MINER_B, seq_len=MINER_T,
                     n=3 * AVG_MINER_STEPS)
    eng = TrainEngine(gpt2.make_model(cfg)[0], device=DEV)
    miner_eng = TrainEngine(gpt2.make_model(cfg)[0], fused_loss=True,
                            device=DEV)
    res: dict = {"model": "gpt2-124m", "eval_batches": AVG_EVAL_BATCHES,
                 "eval_seq_len": EVAL_T}
    with tempfile.TemporaryDirectory() as work:
        root, chain_dir = (os.path.join(work, "artifacts"),
                           os.path.join(work, "chain"))
        t = LocalFSTransport(root)
        loop = AveragerLoop(eng, t, LocalChain(chain_dir,
                                               my_hotkey="hotkey_95"),
                            WeightedAverage(),
                            val_batches=lambda: iter(held))
        loop.bootstrap(params=tree)
        rev0 = loop._base_revision
        check(rev0 is not None and t.base_revision() == rev0,
              "the averager did not publish a genesis base")
        # the miners
        miner = MinerLoop(miner_eng, t, "hotkey_1", clock=FakeClock(),
                          send_interval=1e9, check_update_interval=3.0,
                          wire_v2=True)
        miner.bootstrap()

        def steps(batches):
            for b in batches:
                miner.clock.sleep(1.0)
                yield b

        miner.run(steps(train[:AVG_MINER_STEPS]))
        miner.flush()
        g = torch.Generator(device=DEV).manual_seed(SEED + 5)
        shapes = {k: v.shape for k, v in miner.base_params.items()}

        def noise(scale):
            return {k: torch.randn(s, generator=g, device=DEV) * scale
                    for k, s in shapes.items()}

        _publish_packed(t, "hotkey_2", noise(1e-5), rev0, "int8")
        _publish_packed(t, "hotkey_3", noise(1e-5), rev0, "none")
        t.publish_delta("hotkey_4", gpt2.params_to_numpy(noise(1e-5)))
        t.publish_delta_meta("hotkey_4", {"base_revision": rev0})
        bad, _ = delta.pack_delta_v2(noise(1e-5), density=1.0 / 64.0)
        bad_leaves = dict(bad["leaves"])
        bad_leaves["wpe"] = dict(bad_leaves["wpe"],
                                 idx=bad_leaves["wpe"]["idx"].clone())
        bad_leaves["wpe"]["idx"][0] = shapes["wpe"].numel()  # out of range
        _publish_tree(t, "hotkey_5", {**bad, "leaves": bad_leaves}, rev0,
                      "int8")
        huge, _ = delta.pack_delta_v2(noise(1e-5), density=1.0 / 64.0)
        huge["leaves"]["wte"]["scale"] = torch.tensor(1e6, device=DEV)
        _publish_tree(t, "hotkey_6", huge, rev0, "int8")
        scores = {"hotkey_1": 0.5, "hotkey_2": 0.1, "hotkey_3": 0.15,
                  "hotkey_4": 0.15, "hotkey_5": 0.3, "hotkey_6": 0.3}
        LocalChain(chain_dir, my_hotkey="hotkey_91").set_weights(scores)
        secs: dict = {}
        kept: dict = {}
        _timed_calls(loop, "gather_deltas", secs, kept)
        _timed_calls(loop.strategy, "merge", secs)
        _timed_calls(eng, "evaluate", secs)
        base_before = {k: v.detach().cpu() for k, v in
                       loop.base_params.items()}
        n_indexed = sum(1 for s in shapes.values()
                        if delta.sparse_k(int(np.prod(s)), 1.0 / 64.0)
                        < int(np.prod(s)))
        # round 1 (main path): counts to 0 just before, read just after;
        # the earlier phases' unreachable cycles (the miner phase leaves
        # GBs of them) are collected first, so that the peak is the
        # round's and not the garbage collector's timing
        obs.configure()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        dsc.launches = 0
        t0 = time.perf_counter()
        merged1 = loop.run_round()
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
        launches = {"dequant_scatter": dsc.launches, **fa.launches,
                    **fused_ce.launches}
        peak = torch.cuda.max_memory_allocated()
        snap = obs.flush()
        obs.reset()
        ids, deltas = kept["gather_deltas"]
        weights = loop.strategy._weights_cache[1]
        staged = {s.hotkey: s.reason for s in loop._ingest().stage(
            ["hotkey_5", "hotkey_6"], base_revision=rev0)}
        packed_in = sum(1 for d in deltas if delta.is_packed_v2(d))
        check(merged1 and loop.report.skipped_publishes == 0,
              f"round 1 did not publish (loss {loop.report.last_loss}, "
              f"skipped {loop.report.skipped_publishes})")
        check(ids == ["hotkey_1", "hotkey_2", "hotkey_3", "hotkey_4"],
              f"round 1 merged {ids}")
        check(staged["hotkey_5"] == "no_delta",
              f"the out-of-range miner staged {staged['hotkey_5']}")
        mag = float(np.float32(127.0) * np.float32(1e6))
        want = f"magnitude_exceeded({mag:.3e}>{1e3:.3e})"
        check(staged["hotkey_6"] == want,
              f"the over-cap miner staged {staged['hotkey_6']} != {want}")
        check(loop.report.last_rejected == 1,
              f"round 1 rejected {loop.report.last_rejected}")
        check(snap.get("delta.densify_fallbacks", 0) == 0 and packed_in == 3,
              f"packed submissions densified ({snap}) or missing "
              f"({packed_in})")
        # one launch of the contribution entry per packed contribution
        check(launches["dequant_scatter"] == packed_in
              and n_indexed == 2 + 4 * cfg.n_layer,
              f"dequant_scatter launches {launches['dequant_scatter']} != "
              f"{packed_in} packed contributions")
        n_eval = 2 * AVG_EVAL_BATCHES      # the merged base and the base
        check(launches["flash_attention_fwd"] == cfg.n_layer * n_eval,
              f"flash forward launches {launches['flash_attention_fwd']} "
              f"!= 12 x {n_eval} evaluated batches")
        # the published base against base + sum w_i decode(d_i) by the
        # plain versions (CPU accumulator)
        agg = delta.aggregate_deltas(base_before, deltas, weights)
        fetched = t.fetch_base(loop._host_template())
        pub = gpt2.params_from_numpy(fetched[0], device="cpu")
        base_err = max(float((pub[k] - (base_before[k] + agg[k])).abs().max())
                       for k in pub)
        check(base_err <= 1e-6, f"published base vs plain merge: max abs "
                                f"{base_err} > 1e-6")
        res["round1"] = {
            "accepted": ids, "weights": [float(w) for w in weights],
            "rejected": loop.report.last_rejected, "verdicts": staged,
            "merged_loss": loop.report.last_loss, "launches": launches,
            "published_vs_plain_max_abs": base_err,
            "densify_fallbacks": snap.get("delta.densify_fallbacks", 0),
            "round_s": round_s, "ingest_s": secs["gather_deltas"],
            "merge_s": secs["merge"], "eval_s": secs["evaluate"],
            "peak_cuda_mem_bytes": peak,
            "wire_bytes_fetched": snap.get("wire.bytes_fetched")}
        base_loss1 = loop._base_loss
        res["round1"]["merge_profile"] = _merge_profile(loop, deltas, ids)
        # round 2: the miner pulls the new base, trains, pushes again
        rev1 = loop._base_revision
        miner.run(steps(train[AVG_MINER_STEPS:2 * AVG_MINER_STEPS]))
        miner.flush()
        check(miner._base_revision == rev1 and miner.report.base_pulls == 1,
              f"the miner did not pull the new base ({miner.report})")
        secs.clear()
        _zero_counts()
        dsc.launches = 0
        t0 = time.perf_counter()
        merged2 = loop.run_round()
        torch.cuda.synchronize()
        round2_s = time.perf_counter() - t0
        ids2, _ = kept["gather_deltas"]
        stale = [h for h, r in ((s.hotkey, s.reason) for s in
                                loop._ingest().stage(
                                    [f"hotkey_{i}" for i in range(2, 7)],
                                    base_revision=rev1))
                 if r == "stale_base"]
        check(merged2 and ids2 == ["hotkey_1"],
              f"round 2 merged {ids2} (ok {merged2})")
        check(len(stale) == 5, f"stale submissions not skipped: {stale}")
        check(dsc.launches == 1,
              f"round 2 dequant_scatter launches {dsc.launches} != 1 "
              "packed contribution")
        res["round2"] = {"accepted": ids2, "stale_skipped": stale,
                         "published": loop._base_revision != rev1,
                         "merged_loss": loop.report.last_loss,
                         "base_loss": base_loss1,
                         "dequant_scatter_launches": dsc.launches,
                         "round_s": round2_s,
                         "ingest_s": secs["gather_deltas"],
                         "merge_s": secs["merge"],
                         "eval_s": secs["evaluate"]}
        # the CLI over the same root, after one more push of the miner
        miner.run(steps(train[2 * AVG_MINER_STEPS:]))
        miner.flush()
        miner.close()
        loop.close()
        rev2 = t.base_revision()
        dsc.launches = 0
        t0 = time.perf_counter()
        rc = avg_cli.main(README_AVERAGER_FLAGS + [
            "--work-dir", work, "--rounds", "1", "--hotkey", "hotkey_96"])
        cli_s = time.perf_counter() - t0
        check(rc == 0 and t.base_revision() not in (None, rev2),
              f"neurons.averager.main exited {rc} without a new base")
        check(dsc.launches == 1,
              f"the CLI's dequant_scatter launches {dsc.launches} != 1 "
              "packed contribution")
        res["cli"] = {"argv": README_AVERAGER_FLAGS + ["--rounds", "1"],
                      "rc": rc, "s": cli_s,
                      "dequant_scatter_launches": dsc.launches}
    res["indexed_leaves"] = n_indexed
    log("averager:", json.dumps(res))
    return res


def _scatter_entry(scatter: dict, avg: dict, build: dict) -> dict:
    wte, whole = scatter["timed"]["wte"], scatter["timed"]["contribution"]
    replaces, tpu = SCATTER_TPU
    return {
        "name": "dequant_scatter", "route": "cuda",
        "source": SCATTER_SOURCE, "replaces": replaces, "tpu_kernel": tpu,
        # the averager's round 1, the slice's main path
        "launches": avg["round1"]["launches"]["dequant_scatter"],
        "max_abs_err": max(c["max_abs_err"] for c in scatter["checks"]),
        # one whole GPT-2-124M contribution (50 leaves, one call)
        "ms": whole["ms"], "host_ms": whole["host_ms"],
        "plain_ms": whole["plain_ms"],
        "bound_ms": whole["bound_ms"], "bound_by": whole["bound_by"],
        "library_ms": whole["library_ms"],
        "ms_wte": wte["ms"], "plain_ms_wte": wte["plain_ms"],
        "bound_ms_wte": wte["bound_ms"], "library_ms_wte": wte["library_ms"],
        "library": scatter["library"], "timed_shape": scatter["timed_shape"],
        "build_s": build["build_s"]}


FLASH_SOURCE = "distributedtraining_tpu_torch/csrc/flash_attention.cu"
LIB_FLASH = "jax/experimental/pallas/ops/tpu/flash_attention.py"
FLASH_TPU_KERNELS = {
    "flash_attention_fwd": f"{LIB_FLASH}:_flash_attention_impl "
                           "(pallas_call :758)",
    "flash_attention_bwd_dkv": f"{LIB_FLASH}:_flash_attention_bwd_dkv "
                               "(pallas_call :1121)",
    "flash_attention_bwd_dq": f"{LIB_FLASH}:_flash_attention_bwd_dq "
                              "(pallas_call :1456)",
}


def _flash_entries(flash: dict, train: dict, build: dict) -> list:
    out = []
    for name, tpu in FLASH_TPU_KERNELS.items():
        keys = ("o", "lse") if name == "flash_attention_fwd" else (
            ("dk", "dv") if name.endswith("dkv") else ("dq",))
        checks = flash["checks"]
        out.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": "distributedtraining_tpu/ops/flash_attention.py:86",
            "tpu_kernel": tpu,
            "launches": train["launches"][name],
            # over every case and both dtypes (bf16 dominates)
            "max_abs_err": max(c["max_abs"][key] for c in checks
                               for key in keys),
            # what the f32 limit (1e-5 / 1e-4) applies to
            "max_abs_err_f32": max(c["max_abs"][key] for c in checks
                                   for key in keys
                                   if c["dtype"] == "float32"),
            # what the bf16 limit applies to
            "max_scaled_err_bf16": max(c["max_scaled"][key] for c in checks
                                       if "max_scaled" in c
                                       for key in keys),
            **flash["timed"][name],
            "timed_shape": flash["timed_shape"],
            "build_s": build["build_s"]})
    return out


def _ce_entries(ce: dict, miner: dict, tfused: dict, build: dict) -> list:
    out = []
    for name, (replaces, tpu) in CE_TPU_KERNELS.items():
        keys = CE_OUTPUTS[name]
        checks = ce["checks"]
        at = ce["timed"][name]
        big, small = (at[k] for k in sorted(at, key=lambda k: -int(k[1:])))
        out.append({
            "name": name, "route": "cuda", "source": CE_SOURCE,
            "replaces": replaces, "tpu_kernel": tpu,
            # the miner's round, the slice's main path
            "launches": miner["launches"][name],
            "launches_train_fused": tfused["launches"][name],
            # over every case and both dtypes (bf16 dominates)
            "max_abs_err": max(c["max_abs"][k] for c in checks
                               for k in keys if k in c["max_abs"]),
            # what the limits apply to: in f32 max |kernel - plain| /
            # max(1, max |plain|) <= 1e-5, in bf16 over max |plain|
            # alone <= 2e-2
            "max_scaled_err_f32": max(c["err"][k] for c in checks
                                      for k in keys
                                      if c["dtype"] == "float32"
                                      and k in c["err"]),
            "max_rel_err_bf16": max(c["err"][k] for c in checks
                                    for k in keys
                                    if c["dtype"] == "bfloat16"
                                    and k in c["err"]),
            **({"max_rel_err_bf16_e1280": max(
                c["err"][k] for c in checks for k in keys
                if c["E"] > 1024)} if name == "fused_ce_fwd" else {}),
            **big,
            "ms_n504": small["ms"], "splits_n504": small["splits"],
            **({"ms_n504_one_split": small["ms_one_split"]}
               if "ms_one_split" in small else {}),
            "plain_ms_n504": small["plain_ms"],
            "library_ms_n504": small["library_ms"],
            "bound_ms_n504": small["bound_ms"],
            "library": ce["library"], "timed_shape": ce["timed_shape"],
            "build_s": build["build_s"]})
    return out


def main() -> int:
    t_start = time.perf_counter()
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    from distributedtraining_tpu_torch.models import gpt2
    build = phase_build()
    kern = phase_kernel()
    tok = _tokenizer()
    first = _batches(tok, split="train", batch_size=TRAIN_B,
                     seq_len=TRAIN_T, n=1)[0]
    flash = phase_flash(first["segment_ids"])
    ce = phase_ce(first)
    tree = gpt2.init_params_numpy(gpt2.PRESETS["gpt2-124m"], SEED)
    f32 = phase_slice_f32(tree)
    serve = phase_serve(tree)
    prof = phase_profile(tree)
    train = phase_train(tree, tok)
    parity = phase_train_parity(tree, tok)
    tprof = phase_train_profile(tree, tok)
    tfused = phase_train(tree, tok, fused=True)
    fprof = phase_train_profile(tree, tok, fused=True)
    fparity = phase_fused_parity(tree, tok)
    miner = phase_miner(tree, tok)
    scatter = phase_scatter()
    avg = phase_averager(tree, tok)
    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "distributedtraining_tpu_torch/csrc/paged_attention.cu",
        "replaces": "distributedtraining_tpu/ops/paged_attention.py:107",
        "tpu_kernel": "distributedtraining_tpu/ops/paged_attention.py:"
                      "_decode_kernel",
        "launches": serve["kernel_launches"],
        # over every case and both dtypes (bf16 dominates)
        "max_abs_err": max(c["max_abs_err"] for c in kern["checks"]),
        "max_abs_err_f32": max(c["max_abs_err"] for c in kern["checks"]
                               if c["dtype"] == "float32"),
        "ms": kern["kernel_ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
        "timed_shape": kern["timed_shape"],
        "build_s": build["build_s"]},
        *_flash_entries(flash, train, build),
        *_ce_entries(ce, miner, tfused, build),
        _scatter_entry(scatter, avg, build)]}), flush=True)
    print(json.dumps({"slice": {**serve, "f32_parity": f32,
                                "decode_profile": prof, "card": card}}),
          flush=True)
    print(json.dumps({"train": {**train, "f32_parity": parity,
                                "profile": tprof, "fused": tfused,
                                "fused_profile": fprof,
                                "fused_f32_parity": fparity, "card": card}}),
          flush=True)
    print(json.dumps({"miner": {**miner, "card": card}}), flush=True)
    print(json.dumps({"averager": {**avg, "scatter": scatter, "card": card,
                                   "total_s": time.perf_counter() - t_start}}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        log(f"chip_smoke: FAIL: {e}")
        sys.exit(1)
    except Exception:
        log("chip_smoke: FAIL with an exception:")
        traceback.print_exc()
        sys.exit(1)
