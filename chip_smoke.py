#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (distributedtraining_tpu_torch) on one
NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root

Phases, each of which fails the run (non-zero exit, no result line):

1. env     CUDA must be available (there is no CPU fallback); prints the
           card's name and power limit, torch/CUDA versions, capability.
2. build   compiles every CUDA kernel of the serving path from csrc/.
3. kernel  holds the paged-decode kernel against its plain PyTorch
           version at the GPT-2-124M decode shape and a GQA shape, in
           f32 (TF32 off; max abs <= 1e-5, the summation order differs)
           and in bf16 (max abs <= 2e-2: the plain version rounds the
           softmax probabilities to bf16 before PV, the kernel keeps
           f32); times kernel, plain version and a library yardstick.
4. slice   GPT-2-124M, full width and depth, f32: GenerationEngine's
           greedy output is token-identical to reference_generate.
5. serve   the same weights at the served bf16 compute dtype behind
           ServeLoop + ServeHTTPFrontend: 8 concurrent POST /generate
           requests (prompts of 8-900 tokens, 32 new tokens each) all
           finish, and the decode steps went through the kernel
           (launches == n_layer x decode dispatches > 0).
6. profile torch.profiler over steady decode steps of the same batch:
           wall vs device time per step, idle share, top kernels.

Output: a ``kernels`` JSON line, a ``slice`` JSON line, the
``nvidia-smi`` name/power-limit line, and as the last line
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
SEED = 0


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

def phase_build() -> dict:
    from distributedtraining_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    secs = _cuda.build("paged_attention")
    report = _cuda.library_path("paged_attention")
    ptxas = report.with_name(report.name + ".log")
    text = ptxas.read_text() if ptxas.exists() else ""
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
    spills = sum(1 for line in text.splitlines()
                 if any(int(n) for n in re.findall(r"(\d+) bytes spill",
                                                   line)))
    out = {"build_s": time.perf_counter() - t0, "nvcc_s": secs,
           "max_registers": max(regs) if regs else None,
           "kernels_with_spills": spills}
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


def main() -> int:
    t_start = time.perf_counter()
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    from distributedtraining_tpu_torch.models import gpt2
    build = phase_build()
    kern = phase_kernel()
    tree = gpt2.init_params_numpy(gpt2.PRESETS["gpt2-124m"], SEED)
    f32 = phase_slice_f32(tree)
    serve = phase_serve(tree)
    prof = phase_profile(tree)
    err = {dt: max(c["max_abs_err"] for c in kern["checks"]
                   if c["dtype"] == dt) for dt in ("float32", "bfloat16")}
    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "distributedtraining_tpu_torch/csrc/paged_attention.cu",
        "replaces": "distributedtraining_tpu/ops/paged_attention.py:107",
        "tpu_kernel": "distributedtraining_tpu/ops/paged_attention.py:"
                      "_decode_kernel",
        "launches": serve["kernel_launches"],
        "max_abs_err": max(err.values()),
        "max_abs_err_f32": err["float32"],
        "max_abs_err_bf16": err["bfloat16"],
        "ms": kern["kernel_ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
        "timed_shape": kern["timed_shape"],
        "build_s": build["build_s"]}]}), flush=True)
    print(json.dumps({"slice": {**serve, "f32_parity": f32,
                                "decode_profile": prof, "card": card,
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
