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

Output: a ``kernels`` JSON line, a ``slice`` JSON line, a ``train`` JSON
line, the ``nvidia-smi`` name/power-limit line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
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

def _zero_flash_counts():
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    for key in fa.launches:
        fa.launches[key] = 0


def phase_train(tree, tok) -> dict:
    """The miner's path: TrainEngine.train_step on packed batches, then
    the validator's score of the delta on held-out batches."""
    import math
    import torch
    from distributedtraining_tpu_torch import delta
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    cfg = gpt2.PRESETS["gpt2-124m"]           # bf16 compute, f32 params
    model, _ = gpt2.make_model(cfg)
    train = _batches(tok, split="train", batch_size=TRAIN_B,
                     seq_len=TRAIN_T, n=TRAIN_STEPS)
    held_out = _batches(tok, split="test", batch_size=TRAIN_B,
                        seq_len=EVAL_T, n=EVAL_BATCHES)
    eng = TrainEngine(model, device="cuda")
    state = eng.init_state(gpt2.params_from_numpy(tree, device="cuda"))
    base = {k: v.detach().clone() for k, v in state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # main path: counts to 0 just before, read just after
    _zero_flash_counts()
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
    launches = dict(fa.launches)
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
    p50 = statistics.median(step_ms)
    res = {"model": "gpt2-124m", "dtype": cfg.dtype, "batch": TRAIN_B,
           "seq_len": TRAIN_T, "steps": TRAIN_STEPS, "losses": losses,
           "step_ms_p50": p50, "step_ms_first": step_ms[0],
           "tokens_per_s": TRAIN_B * TRAIN_T / p50 * 1e3,
           "train_s": train_s, "peak_cuda_mem_bytes": peak,
           "eval_seq_len": EVAL_T, "eval_batches": EVAL_BATCHES,
           "base_loss": base_loss, "trained_loss": trained_loss,
           "base_ppl": base_ppl, "trained_ppl": trained_ppl,
           "score": score, "delta_finite": finite, "launches": launches}
    log("train:", json.dumps(res))
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


def phase_train_profile(tree, tok) -> dict:
    """Where a train step's time goes: torch.profiler over steady steps
    at the train phase's shape."""
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
    eng = TrainEngine(model, device="cuda")
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
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    res = {"steps": n_steps, "batch": TRAIN_B, "seq_len": TRAIN_T,
           "wall_ms_per_step": wall_ms / n_steps,
           "device_ms_per_step": busy_ms / n_steps,
           "idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
           "kernels_per_step": sum(v[1] for v in kernels.values()) / n_steps,
           "flash_ms_per_step": flash,
           "top_kernels": [{"name": n[:80], "ms_per_step": v[0] / n_steps,
                            "launches_per_step": v[1] / n_steps}
                           for n, v in top]}
    check(kernels, "the train-step profile saw no device time")
    log("train profile:", json.dumps(res))
    return res


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


def main() -> int:
    t_start = time.perf_counter()
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    from distributedtraining_tpu_torch.models import gpt2
    build = phase_build()
    kern = phase_kernel()
    tok = _tokenizer()
    seg = _batches(tok, split="train", batch_size=TRAIN_B, seq_len=TRAIN_T,
                   n=1)[0]["segment_ids"]
    flash = phase_flash(seg)
    tree = gpt2.init_params_numpy(gpt2.PRESETS["gpt2-124m"], SEED)
    f32 = phase_slice_f32(tree)
    serve = phase_serve(tree)
    prof = phase_profile(tree)
    train = phase_train(tree, tok)
    parity = phase_train_parity(tree, tok)
    tprof = phase_train_profile(tree, tok)
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
        *_flash_entries(flash, train, build)]}), flush=True)
    print(json.dumps({"slice": {**serve, "f32_parity": f32,
                                "decode_profile": prof, "card": card}}),
          flush=True)
    print(json.dumps({"train": {**train, "f32_parity": parity,
                                "profile": tprof, "card": card,
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
