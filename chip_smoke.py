#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (distributedtraining_tpu_torch) on one
NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --decode-ab N
    python3 chip_smoke.py --flash-ab N

The second form is one side of a before/after comparison of the decode
path: copied into the root of each of two checkouts and run from each in
turn within one machine's session, it times the paged-decode wrapper at
the GPT-2-124M decode shape (device ms and host ms, through the public
entry only) and runs the serve phase N times, printing one JSON line
each. It uses nothing but entry points both sides have. The third form,
``--flash-ab N``, is the same for the flash-attention kernels: N times,
phase 4's timing at the training shape (each kernel with and without
segment ids, the profiler's device time of the backward pair and of
SDPA's backward) and the fused train step's profile (phase 12's), one
JSON line each.

Phases, each of which fails the run (non-zero exit, no result line):

1. env     CUDA must be available (there is no CPU fallback); prints the
           card's name and power limit, torch/CUDA versions, capability.
2. build   compiles every CUDA source under csrc/, one nvcc each, all
           started together; reports seconds, registers and spills per
           kernel (ptxas -v).
3. kernel  holds the paged-decode kernel against its plain PyTorch
           version and the plain version of its split decomposition at
           the GPT-2-124M decode shape, a GQA shape, a long-context case
           (MP 256: contexts up to 4096, the split boundaries 0, C - 1,
           C, C + 1 and the whole table) and a G 8 GQA case, in f32
           (TF32 off; max abs <= 1e-5, the summation order differs) and
           in bf16 (max abs <= 2e-2: the plain version rounds the
           softmax probabilities to bf16 before PV, the kernel keeps
           f32); reports the planner's split (C, splits, blocks); times
           kernel, plain version and a library yardstick at the decode
           shape (and the host time of a call) and at the long contexts.
4. flash   holds the flash-attention forward (o, lse) and backward
           (dq, dk, dv) kernels against their plain versions: the
           training shape (B 8, T 1024, H 12, D 64) with segment ids from
           a real packed batch, T 64 and 512, a ragged T, D 128, an
           unpacked case, ids in no order, and long rows (T 4096 packed
           and in no order, T 2112 at D 128: the bf16 kernels' id passes
           sweep a row more than once and their tile lists span more than
           one 32-tile ballot word, dk/dv's running the other way); q, k,
           v as strided views of a fused [B, T, 3E] projection. The
           gradients are held against the dense plain version and against
           the plain version of the kernels' walk
           (flash_attention_bwd_tiled_reference, in the kernels' dtype),
           and a second call on the same inputs must give the same bits.
           f32: max abs <= 1e-5 forward,
           <= 1e-4 gradients (summation order); bf16: <= 2e-2 against the
           plain version's result on the same inputs, each
           difference divided by max(1, |value|) (the bf16 kernels round P
           and dS before their products, as the library does, and the
           output once, each rounding up to 2^-8 of the value; gradients
           exceed 4 at T 1024). Times
           each kernel at the training shape in bf16 (L2 flushed, median
           of 30), with and without segment ids (every causal pair,
           SDPA's work), beside its bound, the plain version and SDPA;
           reads the device time of the backward pair and of SDPA's
           backward with torch.profiler (the kernels' own durations,
           three input sets in turn); logs the key tiles the bf16 kernels
           list there by the Python mirror of their rule
           (ops.flash_attention.visible_key_tiles, not a count from the
           kernels) against the causal tiles.
5. slice   GPT-2-124M, full width and depth, f32: GenerationEngine's
           greedy output is token-identical to reference_generate.
6. serve   the same weights at the served bf16 compute dtype behind
           ServeLoop + ServeHTTPFrontend: 8 concurrent POST /generate
           requests (prompts of 8-900 tokens, 32 new tokens each) all
           finish, and the decode steps went through the kernel
           (launches == n_layer x decode dispatches > 0).
7. profile torch.profiler over steady decode steps of the same batch:
           wall vs device time per step, idle share, top kernels, the
           paged kernel's device ms per step and its share.
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
11. ce     holds the fused cross-entropy forward and backward (dh and dW)
           kernels against their plain versions: the training shape
           (N 8184, V 50304, E 768; 7 vocab chunks) with bf16 h, the f32
           head and the loss mask of a real packed batch, the miner's
           N 504, a ragged N, a vocab that is not a multiple of
           the tile, labels in the last column, an all-zero mask,
           GPT-2-774M's bf16 width (E 1280), f32 at a small shape, f32
           with one vocab split, and the forward alone with one vocab
           split (N 131072). bf16 dh and dW come from one call of the
           backward entry (held against the plain version of its chunked
           decomposition) and from the dh-only and dW-only calls.
           Limits per output: in f32 max |kernel - plain| / max(1,
           max |plain|) <= 1e-5 (summation order); in bf16
           max |kernel - plain| / max |plain| <= 2e-2 against the plain
           version's f32 result on the same values (dz rounded to bf16
           before both products, as the TPU kernels round it, and dh once
           more at the end), and an exactly-zero plain output must come
           back exactly zero. Each case also checks that the limit fails
           a planted wrong gradient (dh or dW zeroed, or negated). Times
           the forward, dh alone, dW alone and the whole backward in bf16
           at N 8184 and N 504 (L2 flushed, median of 30) beside its
           bound, the plain version and the materialised path (two
           library calls: a cuBLAS bf16 GEMM to the logits and
           F.cross_entropy; its backward), the whole backward also at
           GPT-2-774M's width (N 8184, E 1280) and at N 8184 with its dz
           scratch held to 128 MiB; at N 504 the forward and
           the backward also with their splits forced to 1. Reports the
           backward's plan (vocab chunk, K splits, launches a call).
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
17. validator the port's validator round at GPT-2-124M full width and
           depth (bf16 compute, f32 weights) over phase 16's root and a
           fresh LocalChain: three honest MinerLoop miners (--wire-v2
           int8, --wire-v2 f32 kept values, dense v1; fused loss, 4 steps
           each) beside phase 16's stale dense submission and its two
           hostile ones. One validate_and_score round at --val-cohort 8,
           eval at T 512 on 4 batches: the hostiles score 0 with the JAX
           verdicts, the honest miners > 0, flash forward launches == 12
           x 4 x (candidates + the base) and no other kernel; set_weights
           writes non-uniform weights. In f32 compute the cohort path
           equals the sequential score_miner path within 1e-5 relative
           (losses; the honest miners' scores). An AveragerLoop
           WeightedAverage round then merges by exactly those weights,
           read through consensus_scores(). Then ``neurons.validator.main``
           with the README's flags for one round returns 0 and leaves its
           weights on the chain. Reports the round's wall time (staging,
           eval), the eval's device ms per candidate-batch and idle share
           (torch.profiler) and the peak memory.
18. meta   AveragerLoop with ParameterizedMerge (the default strategy) at
           GPT-2-124M over the fleet's submissions (the packed ones
           densified), 2 meta-epochs on 4 batches: finite logits, the
           published base equals base + sum_i softmax(w_t)_i d_i,t by the
           plain versions on the CPU within 1e-6, flash forward == 12 x
           (meta-steps + eval batches), dk/dv == dq == 12 x meta-steps,
           no scatter or CE launch. In f32 at B 2, T 256, 3 meta-steps
           through the kernels and 3 with the attention forced to its
           plain versions: losses within 1e-4 relative, logits within
           1e-4. Then ``neurons.averager.main`` with its default strategy
           publishes a base. Reports the round's wall time and the device
           ms per meta-step (torch.profiler).
19. defaults the three role CLIs with the JAX defaults at GPT-2-124M full
           width and depth on one LocalFS root, changing only the corpus
           and tokenizer (``--dataset synthetic --tokenizer word``) and a
           run's length (``--max-steps``, ``--rounds``): a default miner
           (its own genesis init, a push and a checkpoint at exit), the
           default averager (genesis, then a parameterized round: the
           monolithic base and a manifest of 148 shards each time, one
           lineage record a publish, walk_chain down to genesis), the
           default validator (its pull through the manifest, bit-equal to
           the monolithic base, 148 arrays of 497,903,616 bytes), a
           ``--fused-loss`` miner with a 1 s ``--checkpoint-interval``, a
           second one on the same directory that restores its params,
           moments and step bit for bit and pushes against the same base,
           and a third after the latest checkpoint was corrupted, which
           falls back to a pull. Launches are exact for each run. Then:
           the monolithic, cold and warm sharded pulls and a sharded
           publish timed apart; a torn shard set falls back to the
           monolithic pull; checkpoint saves (sync, async) and a restore
           timed with their bytes; the flight recorder's bundle read back
           through fetch_bundle; a planted loss spike (wte x 50) arming
           exactly one anomaly capture window, which writes a
           torch.profiler trace; a ``--strategy weighted`` CLI round over
           3 packed and 1 dense submissions whose lineage record
           replay_record re-derives within 1e-6 (dequant_scatter == 3
           packed contributions); a record with one byte changed raises
           LineageError. Every earlier phase keeps its opt-out flags.
20. slice5 slice 5 through the role CLIs at GPT-2-124M full width and
           depth on a fresh LocalFS root, every role with
           ``--sign-artifacts`` (its own wallet; ``--base-signer`` the
           publisher): the Ed25519 sign and verify ms on the host and what
           signing adds to a 498 MB base publish and fetch; a ``--hier
           root --outer-momentum 0.9`` genesis; three signed miners
           (``--delta-dtype int8 --fused-loss``, ``--delta-dtype sparse8``,
           ``--wire-v2``; 3 steps each, launches exact) whose int8 and
           sparse8 artifacts equal the plain encoders' bytes on CPU copies
           of the pushed delta, two signed packed submissions, and a
           forgery under hotkey_5's id signed by hotkey_1's key (refused
           with the JAX verdict). Two ``--hier sub`` nodes (n1 with
           ``--hier-wire-v2``): dequant_scatter == the packed
           contributions each folded, the "agg" riders, each mirror holds
           the base's 148 shards (hash-checked) and a fetcher reads the
           base off the mirrors (hits == network shards, bit-equal). The
           root's round: flash launches as phase 18 reads them (7
           meta-epochs + the merged eval), the published base == base +
           0.7 (0.9 v + d) with v = d by the plain versions on the CPU
           within 1e-6 (and the velocity file), the velocity committed
           after the publish; a replayed genesis envelope refused as a
           rolled-back base. A library round whose lease a rival takes
           first stands down: base and velocity file bytes unchanged. A
           ``--standby --failover-deadline 2`` CLI follows a renewing
           primary, takes the lease at its epoch + 1 two seconds after
           the last renewal, bootstraps from the current base and
           publishes a base it signed (3 scatter launches: its packed
           submissions). A signing validator CLI scores the honest
           miners > 0 and the forgery 0 (``no_delta``, the JAX verdict in
           the log). Records whether ``cryptography`` is installed (the
           port never imports it).

Output: a ``kernels`` JSON line, a ``slice`` JSON line, a ``train`` JSON
line, a ``miner`` JSON line, an ``averager`` JSON line, a ``validator``
JSON line (phases 17 and 18), a ``defaults`` JSON line (phase 19), a
``slice5`` JSON line (phase 20), the ``nvidia-smi`` name/power-limit
line,
and as the last line
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
    # the split-boundary contexts of the planner's chunk at P 16 (C 64):
    # 0, C - 1, C, C + 1 and the whole table
    shapes = {
        "gpt2_124m_decode": dict(B=8, Hq=12, Hkv=12, D=64, P=16, MP=64,
                                 lens=[0, 15, 16, 17, 1023, 1024, 300,
                                       777]),
        "gqa_d128": dict(B=4, Hq=32, Hkv=8, D=128, P=16, MP=8,
                         lens=[0, 17, 100, 128]),
        "long_ctx_4096": dict(B=8, Hq=12, Hkv=12, D=64, P=16, MP=256,
                              lens=[0, 63, 64, 65, 4096, 2047, 3001,
                                    4095]),
        "gqa_g8_d128": dict(B=5, Hq=64, Hkv=8, D=128, P=16, MP=64,
                            lens=[0, 63, 65, 1024, 700]),
    }
    tols = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    checks = []
    for i, (name, s) in enumerate(shapes.items()):
        for dtype, tol in tols.items():
            args = _decode_case(s["B"], s["Hq"], s["Hkv"], s["D"], s["P"],
                                s["MP"], s["lens"], dtype, SEED + i)
            out = pa.paged_decode_attention(*args)
            ref = pa.paged_decode_reference(*args)
            split = pa.paged_decode_split_reference(*args)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            err_split = float((out.float() - split.float()).abs().max())
            plan = pa.plan_split(s["MP"], s["P"], s["B"], s["Hkv"])
            checks.append({"shape": name, "dtype": str(dtype).split(".")[1],
                           "max_abs_err": err,
                           "max_abs_err_split_plain": err_split, "tol": tol,
                           "plan": dataclasses.asdict(plan)})
            check(bool(torch.isfinite(out).all()),
                  f"paged decode kernel: non-finite output at {name} {dtype}")
            check(err <= tol, f"paged decode kernel vs plain version at "
                              f"{name} {dtype}: max abs {err} > {tol}")
            check(err_split <= tol,
                  f"paged decode kernel vs the plain split version at "
                  f"{name} {dtype}: max abs {err_split} > {tol}")
    # time the main path's shape at the served dtype (bf16)
    s = shapes["gpt2_124m_decode"]
    args = _decode_case(s["B"], s["Hq"], s["Hkv"], s["D"], s["P"], s["MP"],
                        s["lens"], torch.bfloat16, SEED)
    kernel_ms = _time_ms(lambda: pa.paged_decode_attention(*args))
    host_ms = _host_ms(lambda: pa.paged_decode_attention(*args))
    plain_ms = _time_ms(lambda: pa.paged_decode_reference(*args))
    library_ms = _time_ms(_library_call(args))
    bound_ms, bound_by = _bound(args, 2)
    plan = pa.plan_split(s["MP"], s["P"], s["B"], s["Hkv"])
    # and the long contexts, where the split has the most to share out
    s = shapes["long_ctx_4096"]
    long_args = _decode_case(s["B"], s["Hq"], s["Hkv"], s["D"], s["P"],
                             s["MP"], s["lens"], torch.bfloat16, SEED)
    long = {"ms": _time_ms(lambda: pa.paged_decode_attention(*long_args)),
            "library_ms": _time_ms(_library_call(long_args)),
            "bound_ms": _bound(long_args, 2)[0]}
    res = {"checks": checks, "kernel_ms": kernel_ms, "host_ms": host_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "plan": dataclasses.asdict(plan),
           "long_ctx_4096": long, "timed_shape": "gpt2_124m_decode bf16"}
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


def _differs_bitwise(first: dict, second: dict) -> list:
    """The names whose two results are not equal bit for bit (a NaN
    equals a NaN of the same bits; 0.0 and -0.0 differ)."""
    import torch
    return [key for key, a in first.items()
            if a.shape != second[key].shape or a.dtype != second[key].dtype
            or not torch.equal(a.contiguous().view(torch.uint8),
                               second[key].contiguous().view(torch.uint8))]


def _profiled_ms(calls, reps: int = 30, warm: int = 5) -> dict:
    """Device time of one call by torch.profiler, by kernel name: the
    durations of the kernels the calls launch (no gaps between them, no
    host time), summed over ``reps`` calls and divided by ``reps``.
    ``calls`` close over distinct input sets and are taken in turn, so
    that each call finds its inputs pushed out of the 50 MB L2 by the
    calls before it; no flush kernel enters the sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(warm):
        calls[i % len(calls)]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            calls[i % len(calls)]()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            out[evt.name] = (out.get(evt.name, 0.0)
                             + evt.time_range.elapsed_us() / 1e3 / reps)
    check(out, "the profiler saw no device time")
    return out


def _flash_timing(seg) -> dict:
    """The flash kernels timed at the training shape in bf16 (B 8, T
    1024, H 12, D 64, ``seg`` a real packed batch's ids), beside their
    bounds, the plain versions and SDPA: ``_time_ms`` of each kernel with
    and without the ids, and the torch.profiler reading of the backward
    pair and of SDPA's backward. Uses only the wrappers and plain
    versions the package has had since its flash kernels were first
    ported, so that ``--flash-ab`` can run it against an older
    checkout's package."""
    import torch
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    B, T, H, D = TRAIN_B, TRAIN_T, 12, 64
    sets = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for i in range(3):      # distinct input sets for the profiler
        q, k, v, do, st = _flash_case(B, T, H, D, seg, torch.bfloat16,
                                      SEED + i)
        do = do.contiguous()
        o, lse = fa.flash_attention_fwd(q, k, v, st)
        # and without ids: the backward's inputs for every causal pair
        o_all, lse_all = fa.flash_attention_fwd(q, k, v)
        # the yardstick: SDPA on the same shapes, unpacked, causal
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        out_h = sdpa(qh, kh, vh, is_causal=True)
        sets.append(dict(q=q, k=k, v=v, do=do, st=st, o=o, lse=lse,
                         di=fa._row_dot(o, do), lse_all=lse_all,
                         di_all=fa._row_dot(o_all, do), qh=qh, kh=kh,
                         vh=vh, out_h=out_h,
                         doh=do.transpose(1, 2).contiguous()))
    x = sets[0]
    q, k, v, do, st, o, lse, di = (x[n] for n in (
        "q", "k", "v", "do", "st", "o", "lse", "di"))
    # a check first, so that a wrong kernel gives no time
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, st)
    got = (fa.flash_attention_bwd_dq(q, k, v, do, lse, di, st),
           *fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, st))
    for key, a, r in zip(("dq", "dk", "dv"), got, ref):
        err = _max_err(a, r, scaled=True)
        check(err <= 2e-2, f"flash timing shape: {key} scaled {err}")

    def lib_bwd(x):
        return torch.autograd.grad(x["out_h"], (x["qh"], x["kh"], x["vh"]),
                                   x["doh"], retain_graph=True)

    def rows(x, packed):
        """lse, di and the ids of set x, with or without the ids."""
        return ((x["lse"], x["di"], x["st"]) if packed
                else (x["lse_all"], x["di_all"], None))

    def pair(x, packed):
        fa.flash_attention_bwd_dkv(x["q"], x["k"], x["v"], x["do"],
                                   *rows(x, packed))
        fa.flash_attention_bwd_dq(x["q"], x["k"], x["v"], x["do"],
                                  *rows(x, packed))

    lib_fwd = _time_ms(lambda: sdpa(x["qh"], x["kh"], x["vh"],
                                    is_causal=True))
    lib_bwd_ms = _time_ms(lambda: lib_bwd(x))
    # the plain backward computes dq, dk and dv in one call: both
    # backward kernels are set beside it
    plain_fwd = _time_ms(lambda: fa.flash_attention_reference(q, k, v, st))
    plain_bwd = _time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, st))
    runs = {
        "flash_attention_fwd": (
            lambda packed: fa.flash_attention_fwd(
                q, k, v, st if packed else None), plain_fwd, lib_fwd),
        "flash_attention_bwd_dkv": (
            lambda packed: fa.flash_attention_bwd_dkv(
                q, k, v, do, *rows(x, packed)), plain_bwd, lib_bwd_ms),
        "flash_attention_bwd_dq": (
            lambda packed: fa.flash_attention_bwd_dq(
                q, k, v, do, *rows(x, packed)), plain_bwd, lib_bwd_ms),
    }
    bounds = _flash_bounds(B, T, H, D, seg, 2)
    # without segment ids: every causal pair, SDPA's work
    bounds_all = _flash_bounds(B, T, H, D, None, 2)
    timed = {name: {"ms": _time_ms(lambda: fn(True)), "plain_ms": plain,
                    "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                    "library_ms": lib,
                    "ms_unpacked": _time_ms(lambda: fn(False)),
                    "bound_ms_unpacked": bounds_all[name][0]}
             for name, (fn, plain, lib) in runs.items()}
    # the kernels' own device time, by the profiler
    by_name = {
        "pair": _profiled_ms([lambda x=x: pair(x, True) for x in sets]),
        "pair_unpacked": _profiled_ms([lambda x=x: pair(x, False)
                                       for x in sets]),
        "library_bwd": _profiled_ms([lambda x=x: lib_bwd(x) for x in sets])}
    prof = {key: sum(d.values()) for key, d in by_name.items()}
    for name, kern in (("flash_attention_bwd_dkv", "flash_bwd_dkv_mma"),
                       ("flash_attention_bwd_dq", "flash_bwd_dq_mma")):
        timed[name]["profiler_ms"] = sum(
            v for n, v in by_name["pair"].items() if kern in n)
        timed[name]["profiler_ms_unpacked"] = sum(
            v for n, v in by_name["pair_unpacked"].items() if kern in n)
        timed[name]["pair_profiler_ms"] = prof["pair"]
        timed[name]["pair_profiler_ms_unpacked"] = prof["pair_unpacked"]
        timed[name]["library_profiler_ms"] = prof["library_bwd"]
    return {"timed": timed, "bwd_profiler_ms": prof,
            "bwd_profiler_kernels": {key: dict(sorted(
                d.items(), key=lambda kv: -kv[1])[:6])
                for key, d in by_name.items()}}


def phase_flash(seg) -> dict:
    """Kernel vs plain version for the forward and both backward
    kernels; ``seg`` is a real packed batch's segment ids [8, 1024]."""
    import numpy as np
    import torch
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    # ids in no order (not a packer's layout): tile skipping must test
    # id ranges, not assume documents are contiguous
    rng = np.random.default_rng(SEED)
    scattered = rng.integers(0, 4, (2, 256)).astype(np.int32)
    # long rows: the forward's id pass sweeps the row more than once and
    # its tile list spans more than one 32-tile ballot word (T 4096: 64
    # key tiles); packed documents of 20-400 tokens, and ids in no order
    docs = rng.integers(20, 400, (2, 256))
    packed_long = np.stack([np.repeat(np.arange(256), n)[:4096]
                            for n in docs]).astype(np.int32)
    scattered_long = rng.integers(0, 4, (1, 4096)).astype(np.int32)
    cases = {
        "train_b8_t1024_h12_d64": (8, 1024, 12, 64, seg),
        "t64": (8, 64, 12, 64, seg),
        "t512": (8, 512, 12, 64, seg),
        "ragged_t777": (4, 777, 12, 64, seg),
        "d128_t300": (2, 300, 6, 128, seg),
        "unpacked_t200": (2, 200, 4, 64, None),
        "scattered_ids_t256": (2, 256, 4, 64, scattered),
        "packed_t4096": (2, 4096, 2, 64, packed_long),
        "scattered_ids_t4096": (1, 4096, 2, 64, scattered_long),
        "scattered_ids_t2112_d128": (1, 2112, 2, 128, scattered_long),
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
            # and the plain version of the kernels' walk, in their dtype
            # (bf16: P and dS rounded before their products)
            ref_t = fa.flash_attention_bwd_tiled_reference(
                q, k, v, o, lse, do, st)
            # the same call again must give the same bits: no atomics
            dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, st)
            dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, di, st)
            torch.cuda.synchronize()
            pairs = {"o": (o, ref_o), "lse": (lse, ref_lse),
                     "dq": (dq, ref_g[0]), "dk": (dk, ref_g[1]),
                     "dv": (dv, ref_g[2]), "dq_tiled": (dq, ref_t[0]),
                     "dk_tiled": (dk, ref_t[1]), "dv_tiled": (dv, ref_t[2])}
            dt = str(dtype).split(".")[1]
            changed = _differs_bitwise({"dq": dq, "dk": dk, "dv": dv},
                                       {"dq": dq2, "dk": dk2, "dv": dv2})
            check(not changed, f"flash backward at {name} {dt}: a second "
                               f"call on the same inputs changed {changed}")
            c = {"case": name, "dtype": dt,
                 "max_abs": {key: _max_err(a, r)
                             for key, (a, r) in pairs.items()},
                 "tol_fwd": tol_f, "tol_bwd": tol_b,
                 "bitwise_repeatable": True}
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

    res = _flash_timing(seg)
    # the key tiles the bf16 kernels list at the training shape, by the
    # Python mirror of their rule (not a count the kernels report)
    B, T, H, D, sg = cases["train_b8_t1024_h12_d64"]
    tiles = fa.visible_key_tiles(torch.from_numpy(sg[:B, :T].copy()), T)
    n_tiles = tiles.shape[-1]
    res.update({
        "checks": checks,
        "timed_shape": "B 8, T 1024, H 12, D 64 bf16, packed segment "
                       "ids of a real batch; SDPA unpacked causal",
        "visible_pairs": _causal_pairs(B, T, H, sg),
        "all_pairs": B * H * T * (T + 1) // 2,
        "fwd_key_tiles_by_mirror": H * int(tiles.sum()),
        "fwd_causal_tiles": B * H * n_tiles * (n_tiles + 1) // 2})
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
           "paged_decode_share": paged / busy_ms if busy_ms else None,
           "top_kernels": [{"name": n[:80], "ms_per_step": v[0] / n_steps,
                            "launches_per_step": v[1] / n_steps}
                           for n, v in top]}
    log("profile:", json.dumps(res))
    log(f"decode step: {res['device_ms_per_step']} device ms, the paged "
        f"kernel {res['paged_decode_ms_per_step']} ms "
        f"({res['paged_decode_share']} of it)")
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
          / n_steps for name in ("ce_fwd", *CE_BWD_KERNELS)}
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
    # dh and dW together: the bf16 backward entry, one call for both
    "fused_ce_bwd": ("distributedtraining_tpu/ops/pallas_ce.py:124",
                     "_dh_kernel and _dw_kernel (:143) via _bwd_calls "
                     "(pallas_call :201, :220)"),
}
CE_OUTPUTS = {"fused_ce_fwd": ("loss", "m", "s"),
              "fused_ce_bwd_dh": ("dh", "dh_alone"),
              "fused_ce_bwd_dw": ("dw", "dw_alone"),
              "fused_ce_bwd": ("dh", "dw")}
# the bf16 backward's kernels (csrc/fused_ce.cu)
CE_BWD_KERNELS = ("ce_dz_mma", "ce_prod_mma", "ce_transpose",
                  "ce_sum_splits")
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


def _sms() -> int:
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count


def _ce_plain_bwd(h, w, y, m, s, g, dtype):
    """The plain version of the backward entry for kernels fed ``dtype``:
    in bf16 its chunked decomposition with the chunk the entry takes for
    this shape, in f32 the dense plain backward (one kernel a product)."""
    import torch
    from distributedtraining_tpu_torch.ops import fused_ce
    if dtype != torch.bfloat16:
        return fused_ce.fused_ce_bwd_reference(h, w, y, m, s, g)
    vc = fused_ce._bwd_schedule(h.shape[0], w.shape[0], h.shape[1],
                                _sms())["Vc"]
    return fused_ce.fused_ce_bwd_chunked_reference(h, w, y, m, s, g, vc)


def _ce_run(h, w, y, g, fwd_only: bool = False):
    """The kernels (the forward alone with ``fwd_only``), then the plain
    versions on the same values in f32 (the bf16 limit is held against
    that unrounded result): the forward, the backward entry (dh and dW
    in one call), and dh and dW each alone."""
    import torch
    from distributedtraining_tpu_torch.ops import fused_ce
    loss, m, s = fused_ce.fused_ce_fwd(h, w, y)
    hf, wf = h.float(), w.float()
    r_loss, r_m, r_s = fused_ce.fused_ce_fwd_reference(hf, wf, y)
    outs = {"loss": (loss, r_loss), "m": (m, r_m), "s": (s, r_s)}
    if not fwd_only:
        dh, dw = fused_ce.fused_ce_bwd(h, w, y, m, s, g)
        r_dh, r_dw = _ce_plain_bwd(hf, wf, y, r_m, r_s, g, h.dtype)
        outs.update(dh=(dh, r_dh), dw=(dw, r_dw),
                    dh_alone=(fused_ce.fused_ce_bwd_dh(h, w, y, m, s, g),
                              r_dh),
                    dw_alone=(fused_ce.fused_ce_bwd_dw(h, w, y, m, s, g),
                              r_dw))
    torch.cuda.synchronize()
    return outs


def _ce_bounds(N, V, E, elt=2) -> dict:
    """Least time per function: inputs read once and outputs written once
    over the memory rate vs 2 N V E operations per product at the bf16
    rate (the forward one; dh or dW alone z and its own product; the
    whole backward z and both products)."""
    h, w, row = N * E * elt, V * E * elt, N * 4
    work = {"fused_ce_fwd": (h + w + row + 3 * row, 2 * N * V * E),
            "fused_ce_bwd_dh": (h + w + 4 * row + h, 4 * N * V * E),
            "fused_ce_bwd_dw": (h + w + 4 * row + V * E * 4, 4 * N * V * E),
            "fused_ce_bwd": (h + w + 4 * row + h + V * E * 4,
                             6 * N * V * E)}
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
    """Kernel vs plain version for the fused CE forward and backward;
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
        # GPT-2-774M's width
        "e1280_bf16": (300, 3000, 1280, bf, {}),
        "small_f32": (70, 300, 64, f32, dict(label_last=True)),
        "miner_n504_f32": (504, V, E, f32, {}),
        # 135 row tiles: one vocab split, outputs written by the kernels
        # themselves
        "one_split_n4300_f32": (4300, 1000, 128, f32, {}),
        # 1024 row tiles: one forward split
        "fwd_one_split_n131072_bf16": (131072, 300, 64, bf, {}),
    }
    sms = _sms()
    checks = []
    for i, (name, (n, v, e, dtype, kw)) in enumerate(cases.items()):
        h, w, y, g = _ce_inputs(n, v, e, dtype, SEED + i, **kw)
        splits = {"fwd": (fused_ce._fwd_splits(n, v, sms) if dtype == bf
                          else fused_ce._splits(h, v))}
        if dtype == bf:
            splits["bwd"] = fused_ce._bwd_schedule(n, v, e, sms)
        else:
            splits["dh"] = fused_ce._splits(h, v)
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
            check(all(not outs[k][0].any() for k in
                      ("dh", "dw", "dh_alone", "dw_alone")),
                  "an all-zero mask must give zero gradients")
        del outs, h, w
    timed = {}
    for n, e, seed in ((N, E, SEED), (504, E, SEED + 1), (N, 1280, SEED + 2)):
        key = f"n{n}" if e == E else f"n{n}_e{e}"
        h, w, y, g = _ce_inputs(n, V, e, bf, seed)
        loss, m, s = fused_ce.fused_ce_fwd(h, w, y)
        runs = {"fused_ce_fwd": lambda: fused_ce.fused_ce_fwd(h, w, y),
                "fused_ce_bwd_dh": lambda: fused_ce.fused_ce_bwd_dh(
                    h, w, y, m, s, g),
                "fused_ce_bwd_dw": lambda: fused_ce.fused_ce_bwd_dw(
                    h, w, y, m, s, g),
                "fused_ce_bwd": lambda: fused_ce.fused_ce_bwd(
                    h, w, y, m, s, g)}
        if e != E:   # GPT-2-774M's width: the whole backward alone
            runs = {"fused_ce_bwd": runs["fused_ce_bwd"]}
        plain_fwd = _time_ms(lambda: fused_ce.fused_ce_fwd_reference(h, w, y))
        plain_bwd = _time_ms(lambda: _ce_plain_bwd(h, w, y, m, s, g, bf))
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
        bounds = _ce_bounds(n, V, e)
        plans = {"fused_ce_bwd_dh": dict(dw=False),
                 "fused_ce_bwd_dw": dict(dh=False), "fused_ce_bwd": {}}
        for name, fn in runs.items():
            row = timed.setdefault(name, {})[key] = {
                "ms": _time_ms(fn),
                "plain_ms": plain_fwd if name == "fused_ce_fwd" else plain_bwd,
                "library_ms": lib_f if name == "fused_ce_fwd" else lib_b,
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
            if name == "fused_ce_fwd":
                row["splits"] = fused_ce._fwd_splits(n, V, sms)
            else:
                row["plan"] = fused_ce._bwd_schedule(n, V, e, sms,
                                                     **plans[name])
        if key == f"n{N}":
            # the same backward with the dz scratch at 128 MiB (a test hook
            # that patches the wrapper's budget): what the wider vocab
            # chunk buys at the training shape
            budget = fused_ce.DZ_SCRATCH_BYTES
            fused_ce.DZ_SCRATCH_BYTES = 128 << 20
            try:
                timed["fused_ce_bwd"][key]["ms_dz_128mib"] = _time_ms(
                    runs["fused_ce_bwd"])
            finally:
                fused_ce.DZ_SCRATCH_BYTES = budget
        if n == 504:
            # the forward and the backward with their splits forced to 1
            # (a test hook that patches the wrappers' choices): what the
            # split grids buy at the miner's shape
            auto = fused_ce._k_splits, fused_ce._fwd_splits
            fused_ce._k_splits = lambda *a: 1
            fused_ce._fwd_splits = lambda N, V, sms: 1
            try:
                for name in ("fused_ce_fwd", "fused_ce_bwd"):
                    timed[name][key]["ms_one_split"] = _time_ms(runs[name])
            finally:
                fused_ce._k_splits, fused_ce._fwd_splits = auto
        del h, w, hh, ww
        torch.cuda.empty_cache()
    res = {"checks": checks, "timed": timed,
           "timed_shape": f"N {N} and 504, V {V}, E {E}, bf16 h and head; "
                          f"the backward also at N {N}, E 1280",
           "library": "two library calls: cuBLAS bf16 GEMM to the logits "
                      "(cast to f32) + F.cross_entropy; backward: its "
                      "autograd (dh and dW in one call)",
           "plain": "the plain backward computes dh and dW in one call "
                    "(bf16: the chunked decomposition, the backward "
                    "entry's chunk)"}
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


def _timed_calls(obj, name: str, secs: dict, keep: dict | None = None,
                 sync: bool = True):
    """Wrap ``obj.name`` so that each call's wall time, between two
    device synchronisations, adds to ``secs[name]`` (and its result is
    kept in ``keep[name]``): a measuring hook of this script.
    ``sync=False`` leaves the device alone, for a call on another thread
    that does host work only (the validator's cohort stager)."""
    import torch
    fn = getattr(obj, name)

    def wrapper(*a, **kw):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        if sync:
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


def _device_profile(fn, top: int = 6) -> tuple[dict, dict]:
    """torch.profiler over one call of ``fn``: wall, device time (and the
    host-to-device copies' share of it), the idle share and the ``top``
    kernels; and the device ms and calls by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            k = by.setdefault(evt.name, [0.0, 0])
            k[0] += evt.time_range.elapsed_us() / 1e3
            k[1] += 1
    busy = sum(v[0] for v in by.values())
    check(by, "the profile saw no device time")
    h2d = [v for n, v in by.items() if "HtoD" in n or "Memcpy" in n]
    ranked = sorted(by.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "h2d_copy_ms": sum(v[0] for v in h2d),
            "h2d_copies": sum(v[1] for v in h2d),
            "flash_ms": sum(v[0] for n, v in by.items() if "flash" in n),
            "top": [{"name": n[:60], "ms": v[0], "calls": v[1]}
                    for n, v in ranked]}, by


def _merge_profile(loop, deltas, ids) -> dict:
    """torch.profiler over one more merge of the round's submissions:
    device time by kernel (the scatter kernels and the host-to-device
    copies of idx/q apart), wall, idle share."""
    res, by = _device_profile(lambda: loop.strategy.merge(
        loop.engine, loop.base_params, deltas, ids), top=8)
    res["scatter_kernels_ms"] = sum(v[0] for n, v in by.items()
                                    if "dsc_" in n)
    return res


def phase_averager(tree, tok, work: str) -> dict:
    """The port's averager round at GPT-2-124M full width and depth over
    a LocalFSTransport and a LocalChain in a temporary directory: genesis,
    a MinerLoop --wire-v2 miner, packed int8 and f32 miners, a dense v1
    miner, two hostile ones, weights set through the chain; two rounds,
    then ``neurons.averager.main`` over the same root. ``work`` (an empty
    directory) holds the root and the chain for the later phases."""
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


# ---------------------------------------------------------------------------
# 17. validator, 18. meta merge
# ---------------------------------------------------------------------------

VAL_EVAL_BATCHES = 4
META_EPOCHS = 2
HONEST = ("hotkey_1", "hotkey_2", "hotkey_3")
README_VALIDATOR_FLAGS = [
    "--backend", "local", "--model", "gpt2-124m", "--dataset", "synthetic",
    "--tokenizer", "word", "--no-base-wire-v2", "--flight-events", "0"]


def _honest_miner(t, hotkey, batches, *, wire_v2: bool, quant="int8"):
    """A MinerLoop miner (fused loss) trained on ``batches`` from the
    published base, then one push."""
    from distributedtraining_tpu_torch.engine.scheduler import FakeClock
    from distributedtraining_tpu_torch.engine.train import (MinerLoop,
                                                            TrainEngine)
    from distributedtraining_tpu_torch.models import gpt2
    eng = TrainEngine(gpt2.make_model(gpt2.PRESETS["gpt2-124m"])[0],
                      fused_loss=True, device=DEV)
    miner = MinerLoop(eng, t, hotkey, clock=FakeClock(), send_interval=1e9,
                      check_update_interval=1e9, wire_v2=wire_v2,
                      wire_quant=quant)
    miner.bootstrap()
    miner.run(iter(batches))
    miner.flush()
    miner.close()
    check(miner.report.pushes >= 1, f"{hotkey} pushed nothing")


def phase_validator(tree, tok, work: str) -> dict:
    """The port's validator round at GPT-2-124M full width and depth over
    phase 16's root and a fresh LocalChain: three honest miners (a
    MinerLoop --wire-v2 int8, one with f32 kept values, a dense v1 one)
    next to phase 16's stale dense submission and its two hostile ones;
    one validate_and_score round at --val-cohort 8, the f32 rerun of the
    cohort path against the sequential one, an AveragerLoop
    WeightedAverage round over the validator's weights, then
    ``neurons.validator.main``."""
    import dataclasses as dc
    import numpy as np
    import torch
    from distributedtraining_tpu_torch import delta
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.average import (AveragerLoop,
                                                              WeightedAverage)
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.engine.validate import Validator
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.neurons import validator as val_cli
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    cfg = gpt2.PRESETS["gpt2-124m"]
    held = _batches(tok, split="test", batch_size=MINER_B, seq_len=EVAL_T,
                    n=VAL_EVAL_BATCHES)
    train = _batches(tok, split="train", batch_size=MINER_B,
                     seq_len=MINER_T, n=3 * AVG_MINER_STEPS)
    t = LocalFSTransport(os.path.join(work, "artifacts"))
    res: dict = {"model": "gpt2-124m", "eval_batches": VAL_EVAL_BATCHES,
                 "eval_seq_len": EVAL_T, "cohort": 8}
    t0 = time.perf_counter()
    for i, (h, v2, quant) in enumerate((("hotkey_1", True, "int8"),
                                        ("hotkey_2", True, "none"),
                                        ("hotkey_3", False, "int8"))):
        _honest_miner(t, h, train[i * AVG_MINER_STEPS:
                                  (i + 1) * AVG_MINER_STEPS],
                      wire_v2=v2, quant=quant)
    res["miners_s"] = time.perf_counter() - t0
    rev = t.base_revision()
    chain_dir = os.path.join(work, "chain_val")   # only this validator
    eng = TrainEngine(gpt2.make_model(cfg)[0], device=DEV)
    v = Validator(eng, t, LocalChain(chain_dir, my_hotkey="hotkey_91"),
                  eval_batches=lambda: iter(held), cohort_size=8,
                  ingest_cache_mb=4096)
    secs: dict = {}
    _timed_calls(v, "_stage_many", secs, sync=False)
    _timed_calls(v._evaluator(), "evaluate_cohort", secs)
    # the round (main path): counts to 0 just before, read just after
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    dsc.launches = 0
    t0 = time.perf_counter()
    v.bootstrap()
    boot_s = time.perf_counter() - t0
    results = {s.hotkey: s for s in v.validate_and_score()}
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = {"dequant_scatter": dsc.launches, **fa.launches,
                **fused_ce.launches}
    peak = torch.cuda.max_memory_allocated()
    scored = [h for h, s in results.items() if s.loss is not None]
    mag = float(np.float32(127.0) * np.float32(1e6))
    want = f"magnitude_exceeded({mag:.3e}>{1e3:.3e})"
    check(results["hotkey_5"].reason == "no_delta",
          f"the out-of-range miner: {results['hotkey_5']}")
    check(results["hotkey_6"].reason == want and
          results["hotkey_6"].score == 0.0,
          f"the over-cap miner: {results['hotkey_6']} != {want}")
    check(all(results[h].reason == "ok" and results[h].score > 0
              for h in HONEST),
          f"honest miners: {[results[h] for h in HONEST]}")
    check(results["hotkey_4"].reason == "ok",   # stale, scored ("accept")
          f"the stale miner: {results['hotkey_4']}")
    check(sorted(scored) == ["hotkey_1", "hotkey_2", "hotkey_3",
                             "hotkey_4"], f"scored {scored}")
    n_fwd = cfg.n_layer * VAL_EVAL_BATCHES * (len(scored) + 1)
    check(launches["flash_attention_fwd"] == n_fwd,
          f"flash forward launches {launches['flash_attention_fwd']} != "
          f"{n_fwd} = 12 x {VAL_EVAL_BATCHES} x ({len(scored)} candidates "
          f"+ the base)")
    check(not any(launches[k] for k in launches
                  if k != "flash_attention_fwd"),
          f"the validator's eval launched other kernels: {launches}")
    weights = LocalChain(chain_dir).get_weights("hotkey_91")
    pos = sorted({w for w in weights.values() if w > 0})
    check(len(pos) > 1, f"chain weights not set or uniform: {weights}")
    res["round"] = {
        "scores": {h: results[h].score for h in scored},
        "losses": {h: results[h].loss for h in scored},
        "base_loss": v.base_loss,
        "verdicts": {h: results[h].reason for h in ("hotkey_5", "hotkey_6")},
        "chain_weights": {h: w for h, w in weights.items() if w},
        "launches": launches, "round_s": round_s, "bootstrap_s": boot_s,
        "stage_s": secs.get("_stage_many"),
        "eval_s": secs.get("evaluate_cohort"),
        "peak_cuda_mem_bytes": peak}
    # the eval's device time: one more cohort of the scored candidates
    ing = v._ingest().stage(scored, base_revision=v._base_revision)
    cand = [s.delta for s in ing]
    prof, _ = _device_profile(lambda: v._evaluator().evaluate_cohort(
        v.base_params, cand, iter(held)))
    # the candidates' host-to-device copies (built once a cohort) apart
    prof["device_ms_per_candidate_batch"] = (
        (prof["device_ms"] - prof["h2d_copy_ms"])
        / (len(cand) * VAL_EVAL_BATCHES))
    res["round"]["eval_profile"] = prof
    # f32 compute: the cohort path against the sequential score_miner
    # path (summation order only), staged through the same cache
    cfg32 = dc.replace(cfg, dtype="float32")
    eng32 = TrainEngine(gpt2.make_model(cfg32)[0], device=DEV)
    held32 = held[:2]
    pair = []
    for cohort in (8, 1):
        v32 = Validator(eng32, t, LocalChain(os.path.join(
            work, f"chain_f32_{cohort}"), my_hotkey="hotkey_91"),
            eval_batches=lambda: iter(held32), cohort_size=cohort)
        v32._ingestor = v._ingest()
        v32.base_params, v32._base_revision = v.base_params, rev
        v32._eval_base()
        pair.append(v32)
    coh = {s.hotkey: s for s in pair[0].validate_and_score()}
    seq = {h: pair[1].score_miner(h) for h in scored}
    f32_rel = {}
    for h in scored:
        a, b = coh[h], seq[h]
        rel = abs(a.loss - b.loss) / abs(b.loss)
        srel = abs(a.score - b.score) / max(abs(b.score), 1e-30)
        f32_rel[h] = {"loss_rel": rel, "score_rel": srel,
                      "score": b.score}
        check(rel <= 1e-5, f"f32 cohort vs sequential loss {h}: {rel}")
        check(h not in HONEST or srel <= 1e-5,
              f"f32 cohort vs sequential score {h}: {a.score} vs "
              f"{b.score}")
    res["f32_cohort_vs_sequential"] = f32_rel
    del pair, eng32
    # the next averager round reads the validator's weights
    aloop = AveragerLoop(TrainEngine(gpt2.make_model(cfg)[0], device=DEV),
                         t, LocalChain(chain_dir, my_hotkey="hotkey_95"),
                         WeightedAverage(), val_batches=lambda: iter(held),
                         publish_policy="always")
    aloop.bootstrap()
    t0 = time.perf_counter()
    merged = aloop.run_round()
    avg_s = time.perf_counter() - t0
    aloop.close()
    ids, w = aloop.strategy._weights_cache[0][0], np.asarray(
        aloop.strategy._weights_cache[1])
    consensus = LocalChain(chain_dir).consensus_scores()
    expect = delta.normalized_merge_weights(list(ids), consensus)
    check(merged and list(ids) == list(HONEST),
          f"the weighted round merged {ids} (ok {merged})")
    check(float(np.abs(w - expect).max()) <= 1e-7
          and len(set(np.round(w, 6))) > 1,
          f"merge weights {w} are not the validator's consensus {expect}")
    res["weighted_round"] = {"accepted": list(ids),
                             "weights": [float(x) for x in w],
                             "round_s": avg_s,
                             "published": t.base_revision() != rev}
    v.close()
    # the CLI over the same root, with the README's flags
    t0 = time.perf_counter()
    rc = val_cli.main(README_VALIDATOR_FLAGS + [
        "--work-dir", work, "--rounds", "1", "--hotkey", "hotkey_92"])
    cli_s = time.perf_counter() - t0
    cli_w = LocalChain(os.path.join(work, "chain")).get_weights("hotkey_92")
    check(rc == 0 and any(cli_w.values()),
          f"neurons.validator.main exited {rc}, weights {cli_w}")
    res["cli"] = {"argv": README_VALIDATOR_FLAGS + ["--rounds", "1"],
                  "rc": rc, "s": cli_s,
                  "weights": {h: x for h, x in cli_w.items() if x}}
    log("validator:", json.dumps(res))
    return res


def phase_meta_merge(tree, tok, work: str) -> dict:
    """The averager's default strategy at GPT-2-124M full width and
    depth: AveragerLoop with ParameterizedMerge over the fleet's
    submissions (densified), the published base against the plain
    mixture, launches, a profile, the f32 parity of the meta-steps
    through the kernels and through the plain attention, then
    ``neurons.averager.main`` with its default strategy."""
    from unittest import mock
    import dataclasses as dc
    import numpy as np
    import torch
    from distributedtraining_tpu_torch import delta
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.average import (
        AveragerLoop, ParameterizedMerge)
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.neurons import averager as avg_cli
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    from distributedtraining_tpu_torch.utils import obs
    cfg = gpt2.PRESETS["gpt2-124m"]
    held = _batches(tok, split="test", batch_size=MINER_B, seq_len=EVAL_T,
                    n=VAL_EVAL_BATCHES)
    t = LocalFSTransport(os.path.join(work, "artifacts"))
    model = gpt2.make_model(cfg)[0]
    eng = TrainEngine(model, device=DEV)
    # the fleet's submissions name the bases before the last merges:
    # accepted as the reference averager accepts them
    loop = AveragerLoop(eng, t, LocalChain(os.path.join(work, "chain"),
                                           my_hotkey="hotkey_96"),
                        ParameterizedMerge(model, meta_epochs=META_EPOCHS),
                        val_batches=lambda: iter(held),
                        publish_policy="always", stale_deltas="accept")
    loop.bootstrap()
    rev = loop._base_revision
    base_before = {k: v.detach().cpu() for k, v in loop.base_params.items()}
    secs: dict = {}
    kept: dict = {}
    _timed_calls(loop, "gather_deltas", secs, kept)
    _timed_calls(loop.strategy, "merge", secs, kept)
    _timed_calls(eng, "evaluate", secs)
    obs.configure()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    dsc.launches = 0
    t0 = time.perf_counter()
    merged_ok = loop.run_round()
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = {"dequant_scatter": dsc.launches, **fa.launches,
                **fused_ce.launches}
    peak = torch.cuda.max_memory_allocated()
    snap = obs.flush()
    obs.reset()
    loop.close()
    ids, deltas = kept["gather_deltas"]
    _, w = kept["merge"]
    check(merged_ok and ids == ["hotkey_1", "hotkey_2", "hotkey_3",
                                "hotkey_4"],
          f"the parameterized round merged {ids} (ok {merged_ok})")
    check(t.base_revision() not in (None, rev), "no base was published")
    check(all(bool(torch.isfinite(x).all()) for x in w.values()),
          "non-finite learned logits")
    check(snap.get("delta.densify_fallbacks", 0) == 2,
          f"the two packed submissions did not reach the strategy dense: "
          f"{snap.get('delta.densify_fallbacks')}")
    steps = META_EPOCHS * VAL_EVAL_BATCHES
    n_eval = VAL_EVAL_BATCHES                 # the merged base's eval
    check(launches["flash_attention_fwd"] == cfg.n_layer * (steps + n_eval),
          f"flash forward launches {launches['flash_attention_fwd']} != "
          f"12 x ({steps} meta-steps + {n_eval} eval batches)")
    for key in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        check(launches[key] == cfg.n_layer * steps,
              f"{key} launches {launches[key]} != 12 x {steps} meta-steps")
    check(not any(launches[k] for k in ("dequant_scatter", "fused_ce_fwd",
                                        "fused_ce_bwd_dh",
                                        "fused_ce_bwd_dw")),
          f"the meta merge launched other kernels: {launches}")
    # the published base against the plain mixture on the CPU
    placed = [delta.place_delta(d, base_before) for d in deltas]
    norm = {k: torch.softmax(x.detach().cpu(), dim=0) for k, x in w.items()}
    plain = delta.per_tensor_weighted_merge(base_before, placed, norm)
    pub = gpt2.params_from_numpy(t.fetch_base(loop._host_template())[0],
                                 device="cpu")
    base_err = max(float((pub[k] - plain[k]).abs().max()) for k in pub)
    check(base_err <= 1e-6, f"published base vs the plain mixture: max abs "
                            f"{base_err} > 1e-6")
    del placed, plain, pub
    spread = max(float((x.max() - x.min()).abs()) for x in w.values())
    res: dict = {
        "model": "gpt2-124m", "miners": ids, "meta_epochs": META_EPOCHS,
        "eval_batches": VAL_EVAL_BATCHES, "eval_seq_len": EVAL_T,
        "meta_steps": steps, "launches": launches,
        "published_vs_plain_max_abs": base_err,
        "logit_spread_max": spread,
        "epoch_losses": loop.strategy.last_epoch_losses,
        "merged_loss": loop.report.last_loss, "round_s": round_s,
        "ingest_s": secs["gather_deltas"], "merge_s": secs["merge"],
        "eval_s": secs["evaluate"], "peak_cuda_mem_bytes": peak}
    # one epoch more under the profiler: device ms per meta-step
    one = ParameterizedMerge(model, meta_epochs=1)
    prof, _ = _device_profile(lambda: one.merge(
        eng, loop.base_params, deltas, ids, val_batches=lambda: iter(held)))
    prof["device_ms_per_meta_step"] = (
        (prof["device_ms"] - prof["h2d_copy_ms"]) / VAL_EVAL_BATCHES)
    res["profile"] = prof
    # f32 at B 2, T 256: 3 meta-steps through the kernels, 3 with the
    # attention forced to its plain versions (phase 9's test hook)
    cfg32 = dc.replace(cfg, dtype="float32")
    model32 = gpt2.make_model(cfg32)[0]
    eng32 = TrainEngine(model32, device=DEV)
    small = _batches(tok, split="test", batch_size=2, seq_len=256, n=1)

    def run():
        pm = ParameterizedMerge(model32, meta_epochs=3)
        before = dict(fa.launches)
        _, lw = pm.merge(eng32, loop.base_params, deltas, ids,
                         val_batches=lambda: iter(small))
        return (pm.last_epoch_losses, lw,
                {k: fa.launches[k] - before[k] for k in before})

    k_losses, k_w, k_launch = run()
    with mock.patch.object(fa, "_forward", fa.flash_attention_reference), \
            mock.patch.object(fa, "_backward",
                              fa.flash_attention_bwd_reference):
        p_losses, p_w, p_launch = run()
    check(all(n == cfg.n_layer * 3 for n in k_launch.values()),
          f"kernel run launches {k_launch}")
    check(not any(p_launch.values()), f"plain run launched {p_launch}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
    werr = max(float((k_w[k] - p_w[k]).abs().max()) for k in k_w)
    check(rel <= 1e-4 and werr <= 1e-4,
          f"f32 meta-steps through the kernels vs the plain attention: "
          f"losses {k_losses} vs {p_losses} (rel {rel}), logits {werr}")
    res["f32_parity"] = {"batch": 2, "seq_len": 256, "meta_steps": 3,
                         "kernel_losses": k_losses, "plain_losses": p_losses,
                         "max_rel_diff": rel, "logits_max_abs_diff": werr}
    del eng32, model32
    # the CLI with its default strategy (--strategy parameterized)
    flags = [f for f in README_AVERAGER_FLAGS if f not in ("--strategy",
                                                           "weighted")]
    argv = flags + ["--eval-batches", str(VAL_EVAL_BATCHES), "--meta-epochs",
                    str(META_EPOCHS), "--stale-deltas", "accept",
                    "--publish-policy", "always"]
    rev1 = t.base_revision()
    _zero_counts()
    t0 = time.perf_counter()
    rc = avg_cli.main(argv + ["--work-dir", work, "--rounds", "1",
                              "--hotkey", "hotkey_97"])
    cli_s = time.perf_counter() - t0
    check(rc == 0 and t.base_revision() not in (None, rev1),
          f"neurons.averager.main exited {rc} without a new base")
    # the CLI's held-out stream (the front half of the test split) may
    # hold fewer batches than asked for: n batches give META_EPOCHS x n
    # meta-steps and n eval batches of the merged base
    cli = dict(fa.launches)
    n, rest = divmod(cli["flash_attention_fwd"],
                     cfg.n_layer * (META_EPOCHS + 1))
    cli_steps = META_EPOCHS * n
    check(n > 0 and rest == 0 and all(
        cli[k] == cfg.n_layer * cli_steps
        for k in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")),
          f"the CLI's launches {cli} are not 12 x ({META_EPOCHS} x n "
          f"meta-steps + n eval batches) forward and 12 x {META_EPOCHS} "
          f"x n of each backward kernel")
    res["cli"] = {"argv": argv + ["--rounds", "1"], "rc": rc, "s": cli_s,
                  "eval_batches": n, "meta_steps": cli_steps,
                  "launches": cli}
    log("meta merge:", json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# 19. default command lines
# ---------------------------------------------------------------------------

# what a JAX command line changes on the card: the corpus and tokenizer
# that need no network; the rest are the JAX defaults (--base-wire-v2,
# --lineage, --checkpoint-interval 600, --anomaly-trace, --flight-events
# 512, --strategy parameterized, ...), with only a run's length bounded
DEFAULT_FLAGS = ["--dataset", "synthetic", "--tokenizer", "word"]
# M1's checkpoint interval is shorter than its bootstrap's base pull, so
# its first step submits a periodic save, and its few steps end while
# that save is written (the worker supersedes later periodic submits):
# one periodic save taken while training goes on, then the one at exit
M0_STEPS, M1_STEPS, M2_STEPS, M3_STEPS = 4, 3, 6, 2
CKPT_INTERVAL_S = 0.5
SPIKE_STEPS = 10
WIRE_LEAVES, WIRE_BYTES = 148, 497_903_616    # GPT-2-124M, f32, wte padded


def _host_state(state) -> dict:
    """A CPU copy of a TrainState's step, count, params and moments."""
    opt = state.opt_state
    copy = lambda tree: {k: v.detach().cpu().clone()  # noqa: E731
                         for k, v in tree.items()}
    return {"step": int(state.step), "count": int(opt.count),
            "params": copy(state.params), "mu": copy(opt.mu),
            "nu": copy(opt.nu)}


def _same_state(a: dict, b: dict) -> bool:
    import torch
    return (a["step"] == b["step"] and a["count"] == b["count"] and all(
        a[t].keys() == b[t].keys() and all(
            torch.equal(a[t][k], b[t][k]) for k in a[t])
        for t in ("params", "mu", "nu")))


def _bit_equal_trees(a, b) -> bool:
    import numpy as np
    from distributedtraining_tpu_torch import delta
    fa, fb = delta.flatten_tree(a), delta.flatten_tree(b)
    return fa.keys() == fb.keys() and all(
        np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype
        and np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa)


class _Watch:
    """Measuring hooks of this script on the classes the role CLIs build
    (the CLIs construct their own objects): each wrapped call's wall time
    and what the checks need, kept in ``seen``. ``hook_s`` sums the time
    the hooks themselves take (host copies of the state for the checks),
    which ``_cli`` takes off a CLI's wall time."""

    def __init__(self):
        self.seen: dict[str, list] = {}
        self.hook_s = 0.0
        self._undo: list = []

    def _wrap(self, cls, name, note, before=None):
        real = getattr(cls, name)

        def wrapper(obj, *a, **kw):
            t0 = time.perf_counter()
            if before is not None:
                before(obj)
            t1 = time.perf_counter()
            out = real(obj, *a, **kw)
            t2 = time.perf_counter()
            self.seen.setdefault(name, []).append(note(obj, a, out, t2 - t1))
            self.hook_s += (t1 - t0) + (time.perf_counter() - t2)
            return out

        setattr(cls, name, wrapper)
        self._undo.append((cls, name, real))

    def __enter__(self):
        from distributedtraining_tpu_torch.checkpoint import CheckpointStore
        from distributedtraining_tpu_torch.engine import basedist
        from distributedtraining_tpu_torch.engine.train import MinerLoop
        from distributedtraining_tpu_torch.transport import LocalFSTransport
        self._wrap(basedist.BaseFetcher, "fetch",
                   lambda f, a, out, s: {"fetcher": f, "s": s, "got": out})
        self._wrap(basedist.BasePublisher, "publish_revision",
                   lambda p, a, out, s: {"ok": out, "s": s, "rev": a[1],
                                         **(p.last_publish or {})})
        self._wrap(LocalFSTransport, "publish_base",
                   lambda t, a, out, s: {"s": s, "rev": out})
        self._wrap(CheckpointStore, "save",
                   lambda st, a, out, s: {"s": s, "step": a[0], "bytes": sum(
                       os.path.getsize(os.path.join(st.directory, str(a[0]),
                                                    n))
                       for n in os.listdir(os.path.join(st.directory,
                                                        str(a[0]))))})
        self._wrap(MinerLoop, "_save_checkpoint",
                   lambda loop, a, out, s: {"s": s})
        self._wrap(MinerLoop, "_restore_checkpoint",
                   lambda loop, a, out, s: {
                       "ok": out, "s": s,
                       "state": _host_state(loop.state) if out else None,
                       "rev": loop._base_revision})
        # the state the flush's final checkpoint holds (no step between)
        self._wrap(MinerLoop, "flush",
                   lambda loop, a, out, s: {"s": s, "rev":
                                            loop._base_revision},
                   before=lambda loop: self.seen.setdefault(
                       "flushed_state", []).append(_host_state(loop.state)))
        return self

    def __exit__(self, *exc):
        for cls, name, real in reversed(self._undo):
            setattr(cls, name, real)

    def take(self) -> dict:
        out, self.seen = self.seen, {}
        return out


def _cli(module, argv, watch) -> dict:
    """One role CLI's ``main``, the launch counts set to 0 just before
    and read just after; its return code, wall time less the hooks' own
    (``hook_s``), launches and what the hooks saw."""
    import torch
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    torch.cuda.synchronize()
    _zero_counts()
    dsc.launches = 0
    hook0 = watch.hook_s
    t0 = time.perf_counter()
    rc = module.main(argv)
    torch.cuda.synchronize()
    hook_s = watch.hook_s - hook0
    return {"argv": argv, "rc": rc,
            "s": time.perf_counter() - t0 - hook_s, "hook_s": hook_s,
            "launches": {"dequant_scatter": dsc.launches, **fa.launches,
                         **fused_ce.launches},
            "seen": watch.take()}


def _check_launches(what: str, got: dict, want: dict) -> None:
    for key in got:
        n = want.get(key, 0)
        check(got[key] == n, f"{what}: {key} launches {got[key]} != {n}")
    check(any(want.values()), f"{what}: no kernel launch expected")


def _train_want(cfg, steps: int, fused: bool) -> dict:
    """Launches of ``steps`` train steps with no eval."""
    want = {"flash_attention_fwd": cfg.n_layer * steps,
            "flash_attention_bwd_dkv": cfg.n_layer * steps,
            "flash_attention_bwd_dq": cfg.n_layer * steps}
    if fused:
        want.update(fused_ce_fwd=steps, fused_ce_bwd_dh=steps,
                    fused_ce_bwd_dw=steps)
    return want


def _sharded_pull(what: str, run: dict, t, template) -> dict:
    """The run's base pulls went through the manifest (no fallback) and
    assembled the monolithic base bit for bit."""
    fetches = run["seen"].get("fetch", [])
    check(fetches, f"{what}: no base pull through the fetcher")
    f = fetches[-1]["fetcher"]
    check(f.sharded_fetches_total >= 1 and f.fallbacks_total == 0,
          f"{what}: sharded pulls {f.sharded_fetches_total}, fallbacks "
          f"{f.fallbacks_total}")
    tree, rev = fetches[-1]["got"]
    mono, mono_rev = t.fetch_base(template)
    check(rev == mono_rev and _bit_equal_trees(tree, mono),
          f"{what}: the assembled base differs from the monolithic one")
    return {"sharded_fetches": f.sharded_fetches_total,
            "fallbacks": f.fallbacks_total, "fetch_s": fetches[-1]["s"],
            "bytes": f.last_fetch_bytes,
            "shards_fetched": f.network_shards_total,
            "store_hits": f.store_hits_total}


def _manifest(t, rev) -> dict:
    from distributedtraining_tpu_torch import serialization as ser
    from distributedtraining_tpu_torch.transport import base as tbase
    man = ser.parse_base_manifest(tbase.fetch_base_manifest_bytes(t, rev))
    check(man is not None and man["revision"] == rev,
          f"no manifest for {rev}")
    return man


def phase_defaults(tree, tok) -> dict:
    """The three role CLIs with the JAX defaults at GPT-2-124M full width
    and depth (bf16 compute, f32 weights) on one LocalFS root, and the
    planes those defaults turn on: the sharded base, lineage records,
    local checkpoints, the flight recorder and the anomaly monitor."""
    import tempfile
    import numpy as np
    import torch
    from distributedtraining_tpu_torch.checkpoint import (CheckpointStore,
                                                          Snapshot)
    from distributedtraining_tpu_torch.config import RunConfig
    from distributedtraining_tpu_torch.engine import lineage
    from distributedtraining_tpu_torch.engine.basedist import (BaseFetcher,
                                                               BasePublisher)
    from distributedtraining_tpu_torch.engine.scheduler import FakeClock
    from distributedtraining_tpu_torch.engine.train import (
        MinerLoop, TrainEngine, _abstract_state, _wire_template)
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.neurons import averager as avg_cli
    from distributedtraining_tpu_torch.neurons import miner as miner_cli
    from distributedtraining_tpu_torch.neurons import validator as val_cli
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    from distributedtraining_tpu_torch.transport import base as tbase
    from distributedtraining_tpu_torch.utils import flight, obs
    from distributedtraining_tpu_torch.utils.metrics import TraceCapture
    cfg = gpt2.PRESETS["gpt2-124m"]
    template = _wire_template(gpt2.make_model(cfg)[0])
    res: dict = {"model": "gpt2-124m", "flags": DEFAULT_FLAGS}
    with tempfile.TemporaryDirectory() as work, _Watch() as watch:
        t = LocalFSTransport(os.path.join(work, "artifacts"))
        base = DEFAULT_FLAGS + ["--work-dir", work]
        # M0: a default miner on the empty root (its own genesis init,
        # the one push and a checkpoint at exit)
        m0 = _cli(miner_cli, base + ["--hotkey", "hotkey_1", "--max-steps",
                                     str(M0_STEPS)], watch)
        check(m0["rc"] == 0 and t.fetch_delta_bytes("hotkey_1"),
              f"the default miner exited {m0['rc']} without a delta")
        _check_launches("default miner", m0["launches"],
                        _train_want(cfg, M0_STEPS, fused=False))
        check(len(m0["seen"].get("save", [])) == 1,
              f"the default miner saved {m0['seen'].get('save')}")
        # A1: the default averager: genesis, then a parameterized round
        a1 = _cli(avg_cli, base + ["--hotkey", "hotkey_95", "--rounds", "1"],
                  watch)
        pubs, monos = a1["seen"].get("publish_revision", []), \
            a1["seen"].get("publish_base", [])
        check(a1["rc"] == 0 and len(pubs) == len(monos) == 2
              and all(p["ok"] for p in pubs),
              f"the default averager exited {a1['rc']}: publishes "
              f"{monos}, sharded {pubs}")
        genesis, r1 = pubs[0]["rev"], pubs[1]["rev"]
        check(t.base_revision() == r1 and [m["rev"] for m in monos] ==
              [genesis, r1], "the sharded publishes name other revisions")
        for p in pubs:
            check(len(_manifest(t, p["rev"])["layers"]) == WIRE_LEAVES,
                  f"manifest of {p['rev']} does not list {WIRE_LEAVES}")
        check(pubs[0]["shards_uploaded"] == WIRE_LEAVES,
              f"genesis uploaded {pubs[0]['shards_uploaded']} shards")
        records = lineage.walk_chain(t, r1)
        check(len(records) == 2 and records[-1]["strategy"] == "genesis"
              and records[-1]["parent"] is None
              and records[0]["parent"] == genesis,
              f"walk_chain gave {[r.get('revision') for r in records]}")
        fwd = a1["launches"]["flash_attention_fwd"]
        n, rest = divmod(fwd, cfg.n_layer * 9)   # 7 epochs + merged + base
        _check_launches("default averager", a1["launches"], {
            "flash_attention_fwd": cfg.n_layer * 9 * n,
            "flash_attention_bwd_dkv": cfg.n_layer * 7 * n,
            "flash_attention_bwd_dq": cfg.n_layer * 7 * n})
        check(n > 0 and rest == 0, f"default averager fwd launches {fwd}")
        res["averager"] = {
            "rc": a1["rc"], "s": a1["s"],
            "hook_s": a1["hook_s"], "eval_batches": n,
            "launches": a1["launches"],
            "monolithic_publish_s": [m["s"] for m in monos],
            "sharded_publish_s": [p["s"] for p in pubs],
            "shards_uploaded": [p["shards_uploaded"] for p in pubs],
            "shards_skipped": [p["shards_skipped"] for p in pubs],
            "sharded_publish_bytes": [p["bytes"] for p in pubs],
            "records": len(records)}
        # V1: the default validator's bootstrap pulls through the manifest
        v1 = _cli(val_cli, base + ["--hotkey", "hotkey_91", "--rounds", "1"],
                  watch)
        check(v1["rc"] == 0, f"the default validator exited {v1['rc']}")
        res["validator"] = {"rc": v1["rc"], "s": v1["s"],
                            "hook_s": v1["hook_s"],
                            "launches": v1["launches"],
                            **_sharded_pull("validator", v1, t, template)}
        got_tree = v1["seen"]["fetch"][-1]["got"][0]
        leaves = list(_leaves(got_tree))
        check(len(leaves) == WIRE_LEAVES and sum(
            np.asarray(x).nbytes for x in leaves) == WIRE_BYTES,
              f"the assembled base holds {len(leaves)} arrays of "
              f"{sum(np.asarray(x).nbytes for x in leaves)} bytes")
        fwd = v1["launches"]["flash_attention_fwd"]
        n_v, rest = divmod(fwd, cfg.n_layer * 2)   # the base + hotkey_1
        _check_launches("default validator", v1["launches"],
                        {"flash_attention_fwd": cfg.n_layer * 2 * n_v})
        check(n_v > 0 and rest == 0, f"validator fwd launches {fwd}")
        del got_tree, leaves
        # M1: a --fused-loss miner with a short checkpoint interval
        ck = ["--hotkey", "hotkey_2", "--fused-loss",
              "--checkpoint-interval", str(CKPT_INTERVAL_S)]
        m1 = _cli(miner_cli, base + ck + ["--max-steps", str(M1_STEPS)],
                  watch)
        check(m1["rc"] == 0, f"the checkpointing miner exited {m1['rc']}")
        _check_launches("checkpointing miner", m1["launches"],
                        _train_want(cfg, M1_STEPS, fused=True))
        saves = m1["seen"].get("save", [])
        check(len(saves) >= 2, f"the miner saved {len(saves)} checkpoints "
                               "(a periodic one and the one at exit)")
        check(len(m1["seen"]["_save_checkpoint"]) >= 2,
              "the miner took no periodic checkpoint")
        at_save = m1["seen"]["flushed_state"][-1]
        pull1 = _sharded_pull("checkpointing miner", m1, t, template)
        check(m1["seen"]["flush"][-1]["rev"] == r1,
              "the checkpointing miner does not train on the base")
        # M2: a new miner on the same directory (the default interval)
        # restores and trains on
        resume = base + ["--hotkey", "hotkey_2", "--fused-loss"]
        m2 = _cli(miner_cli, resume + ["--max-steps", str(M2_STEPS)], watch)
        restore = m2["seen"]["_restore_checkpoint"][-1]
        check(m2["rc"] == 0 and restore["ok"],
              f"the miner exited {m2['rc']}, restored {restore['ok']}")
        check(_same_state(restore["state"], at_save),
              "the restored params, moments or step differ from the state "
              "at the save")
        meta = t.fetch_delta_meta("hotkey_2")
        check(restore["rev"] == r1 and meta["base_revision"] == r1,
              f"the resumed miner's push names {meta['base_revision']}, "
              f"not {r1}")
        _check_launches("resumed miner", m2["launches"],
                        _train_want(cfg, M2_STEPS, fused=True))
        pull2 = _sharded_pull("resumed miner", m2, t, template)
        # M3: a corrupt latest checkpoint falls back to a pull
        store = CheckpointStore(os.path.join(work, "checkpoints",
                                             "hotkey_2"))
        latest = os.path.join(store.directory, str(store.latest_step()),
                              "state.msgpack")
        with open(latest, "r+b") as f:
            f.truncate(os.path.getsize(latest) // 3)
        m3 = _cli(miner_cli, resume + ["--max-steps", str(M3_STEPS)], watch)
        check(m3["rc"] == 0 and not m3["seen"]["_restore_checkpoint"][-1][
            "ok"], "the corrupt checkpoint was restored")
        pull3 = _sharded_pull("miner after a corrupt checkpoint", m3, t,
                              template)
        _check_launches("miner after a corrupt checkpoint", m3["launches"],
                        _train_want(cfg, M3_STEPS, fused=True))
        res["miners"] = {
            "default": {"rc": m0["rc"], "s": m0["s"], "hook_s": m0["hook_s"],
                        "steps": M0_STEPS, "launches": m0["launches"]},
            "checkpointing": {"rc": m1["rc"], "s": m1["s"],
                              "hook_s": m1["hook_s"],
                              "steps": M1_STEPS, "saves": len(saves),
                              "save_worker_s": [x["s"] for x in saves],
                              "save_bytes": saves[-1]["bytes"],
                              "save_submit_ms": [
                                  x["s"] * 1e3 for x in
                                  m1["seen"]["_save_checkpoint"]],
                              "launches": m1["launches"], "pull": pull1},
            "resumed": {"rc": m2["rc"], "s": m2["s"], "hook_s": m2["hook_s"],
                        "steps": M2_STEPS,
                        "restore_s": restore["s"], "step": at_save["step"],
                        "launches": m2["launches"], "pull": pull2},
            "corrupt_checkpoint": {"rc": m3["rc"], "s": m3["s"],
                                   "hook_s": m3["hook_s"],
                                   "launches": m3["launches"],
                                   "pull": pull3}}
        # the flight recorder and the instruments on from here to the
        # bundle's read-back
        obs.configure()
        flight.configure("miner", "chip_smoke", transport=t,
                         config=RunConfig.from_args("miner", DEFAULT_FLAGS))
        # the base plane, timed apart: monolithic, cold and warm sharded
        t0 = time.perf_counter()
        mono = t.fetch_base(template)
        mono_s = time.perf_counter() - t0
        f = BaseFetcher(t)
        t0 = time.perf_counter()
        cold = f.fetch(template)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = f.fetch(template)
        warm_s = time.perf_counter() - t0
        check(_bit_equal_trees(cold[0], mono[0]) and _bit_equal_trees(
            warm[0], mono[0]) and f.fallbacks_total == 0
              and f.store_hits_total >= WIRE_LEAVES,
              "the timed sharded pulls differ from the monolithic base")
        # a sharded publish of every shard, apart from the CLI's
        pub = BasePublisher(t)
        t0 = time.perf_counter()
        check(pub.publish_revision(mono[0], mono[1]),
              "the timed sharded publish failed")
        publish_s = time.perf_counter() - t0
        # a torn shard set falls back to the monolithic pull
        sid = tbase.base_shard_id("wte")
        good = t.fetch_delta_bytes(sid)
        t.publish_raw(sid, good[:-1] + bytes([good[-1] ^ 0xFF]))
        torn = BaseFetcher(t)
        got = torn.fetch(template)
        t.publish_raw(sid, good)
        check(got is not None and torn.fallbacks_total == 1
              and torn.sharded_fetches_total == 0
              and _bit_equal_trees(got[0], mono[0]),
              "a torn shard set did not fall back to the monolithic base")
        res["base_plane"] = {"monolithic_fetch_s": mono_s,
                             "cold_sharded_fetch_s": cold_s,
                             "warm_sharded_fetch_s": warm_s,
                             "cold_shards_fetched": f.network_shards_total,
                             "warm_store_hits": f.store_hits_total,
                             "sharded_publish_s": publish_s,
                             "sharded_publish_bytes":
                                 pub.last_publish["bytes"],
                             "torn_falls_back": True}
        del mono, cold, warm, got, f, torn, pub
        # a sync checkpoint save and its restore timed apart (M1's hooks
        # time the async save: the submit and the worker's write)
        eng = TrainEngine(gpt2.make_model(cfg)[0], fused_loss=True,
                          device=DEV)
        store = CheckpointStore(os.path.join(work, "ck_timed"))
        loop = MinerLoop(eng, t, "chip_smoke", clock=FakeClock(),
                         send_interval=1e9, check_update_interval=1e9,
                         push_async=False, checkpoint_store=store,
                         checkpoint_interval=1e9,
                         base_fetcher=BaseFetcher(t))
        loop.bootstrap()
        loop.run(iter(_batches(tok, split="train", batch_size=MINER_B,
                               seq_len=MINER_T, n=2)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop._save_checkpoint()
        sync_s = time.perf_counter() - t0
        step_dir = os.path.join(store.directory, str(store.latest_step()))
        ck_bytes = sum(os.path.getsize(os.path.join(step_dir, n))
                       for n in os.listdir(step_dir))
        saved = _host_state(loop.state)
        loop.close()
        t0 = time.perf_counter()
        snap = store.restore(Snapshot(_abstract_state(eng.model), None,
                                      None))
        restore_s = time.perf_counter() - t0
        check(snap is not None and _same_state(_host_state(snap.state),
                                               saved),
              "the timed checkpoint does not restore the saved state")
        store.close()
        bid = flight.freeze_and_publish("chip_smoke")
        bundle = flight.fetch_bundle(t, "miner", "chip_smoke")
        raw = tbase.fetch_postmortem_bytes(t, "miner", "chip_smoke")
        kinds = sorted({e["kind"] for e in bundle["events"]}) if bundle \
            else []
        check(bid is not None and bundle is not None
              and bundle["bundle_id"] == bid
              and flight.parse_bundle(raw) == bundle
              and {"config", "span", "publish"} <= set(kinds),
              f"the flight bundle {bid} does not read back: {kinds}")
        flight.reset()
        obs.reset()
        res["checkpoint"] = {"bytes": ck_bytes, "sync_save_s": sync_s,
                             "restore_s": restore_s}
        res["flight"] = {"bundle_id": bid, "events": len(bundle["events"]),
                         "kinds": kinds, "bytes": len(raw)}
        del saved, snap, loop
        # a planted loss spike arms one capture window
        anomaly_dir = os.path.join(work, "anomaly_traces", "hotkey_7")
        cap = TraceCapture(anomaly_dir,
                           steps=RunConfig().profile_steps, arm=False)
        mon = obs.AnomalyMonitor(cap)

        class _NullSink:       # the loss reaches the monitor at the log
            def log(self, record, step=None):   # cadence, as in JAX
                pass

        spiker = MinerLoop(eng, t, "hotkey_7", clock=FakeClock(),
                           send_interval=1e9, check_update_interval=1e9,
                           metrics=_NullSink(), log_every=1, anomaly=mon,
                           base_fetcher=BaseFetcher(t))
        spike_batches = _batches(tok, split="train", batch_size=MINER_B,
                                 seq_len=MINER_T, n=2 * SPIKE_STEPS)
        _zero_counts()
        dsc.launches = 0
        spiker.bootstrap()
        spiker.run(iter(spike_batches[:SPIKE_STEPS]))
        check(mon.triggered is None, f"anomaly before the spike: "
                                     f"{mon.triggered}")
        with torch.no_grad():      # the planted divergence
            spiker.state.params["wte"].mul_(50.0)
        spiker.run(iter(spike_batches[SPIKE_STEPS:]))
        spiker.flush()
        spiker.close()
        torch.cuda.synchronize()
        spike_launches = {"dequant_scatter": dsc.launches, **fa.launches,
                          **fused_ce.launches}
        _check_launches("anomaly miner", spike_launches,
                        _train_want(cfg, 2 * SPIKE_STEPS, fused=True))
        files = os.listdir(anomaly_dir) if os.path.isdir(anomaly_dir) else []
        check(mon.triggered == "loss_spike" and len(files) == 1
              and not cap.armed and cap.trace_path is not None,
              f"anomaly {mon.triggered}, traces {files}")
        with open(cap.trace_path) as fh:
            names = [e.get("name", "") for e in json.load(fh)["traceEvents"]]
        check(any("flash" in n for n in names),
              "the capture window holds no kernel of the step")
        res["anomaly"] = {"launches": spike_launches,
                          "triggered": mon.triggered, "trace_files": files,
                          "trace_events": len(names),
                          "trace_bytes": os.path.getsize(cap.trace_path)}
        del spiker, eng
        # a --strategy weighted round over a fleet like phase 16's round 1
        # (3 packed, 1 dense), then its lineage record replayed
        res["replay"] = _defaults_replay(tree, tok, work, watch)
    runs = [res["averager"], res["validator"], res["anomaly"],
            res["replay"]["cli"], *res["miners"].values()]
    res["launches"] = {k: sum(r["launches"][k] for r in runs)
                       + res["replay"]["replay_launches"].get(k, 0)
                       for k in runs[0]["launches"]}
    log("defaults:", json.dumps(res))
    return res


def _defaults_replay(tree, tok, work: str, watch) -> dict:
    import torch
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine import lineage
    from distributedtraining_tpu_torch.engine.average import (AveragerLoop,
                                                              WeightedAverage)
    from distributedtraining_tpu_torch.engine.basedist import BasePublisher
    from distributedtraining_tpu_torch.engine.train import (TrainEngine,
                                                            _wire_template)
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.neurons import averager as avg_cli
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    from distributedtraining_tpu_torch.transport import base as tbase
    cfg = gpt2.PRESETS["gpt2-124m"]
    rwork = os.path.join(work, "replay")
    t = LocalFSTransport(os.path.join(rwork, "artifacts"))
    chain = os.path.join(rwork, "chain")
    eng = TrainEngine(gpt2.make_model(cfg)[0], device=DEV)
    genesis = AveragerLoop(eng, t, LocalChain(chain, my_hotkey="hotkey_95"),
                           WeightedAverage(), val_batches=lambda: iter([]),
                           lineage=lineage.LineagePlane(t, node="hotkey_95"),
                           base_dist=BasePublisher(t))
    genesis.bootstrap(params=tree)
    genesis.close()
    rev0 = t.base_revision()
    del genesis, eng
    _honest_miner(t, "hotkey_1", _batches(
        tok, split="train", batch_size=MINER_B, seq_len=MINER_T,
        n=AVG_MINER_STEPS), wire_v2=True)
    g = torch.Generator(device=DEV).manual_seed(SEED + 19)
    shapes = {k: v.shape for k, v in gpt2.params_from_numpy(
        tree, device=DEV).items()}

    def noise():
        return {k: torch.randn(s, generator=g, device=DEV) * 1e-5
                for k, s in shapes.items()}

    _publish_packed(t, "hotkey_2", noise(), rev0, "int8")
    _publish_packed(t, "hotkey_3", noise(), rev0, "none")
    t.publish_delta("hotkey_4", gpt2.params_to_numpy(noise()))
    t.publish_delta_meta("hotkey_4", {"base_revision": rev0})
    # close enough that the chain's MAD screen keeps every weight
    LocalChain(chain, my_hotkey="hotkey_91").set_weights(
        {"hotkey_1": 0.4, "hotkey_2": 0.3, "hotkey_3": 0.35,
         "hotkey_4": 0.3})
    run = _cli(avg_cli, DEFAULT_FLAGS + [
        "--work-dir", rwork, "--strategy", "weighted", "--rounds", "1",
        "--hotkey", "hotkey_95"], watch)
    head = t.base_revision()
    check(run["rc"] == 0 and head != rev0,
          f"the weighted averager exited {run['rc']} without a new base")
    check(run["launches"]["dequant_scatter"] == 3,
          f"the weighted round's scatter launches "
          f"{run['launches']['dequant_scatter']} != 3 packed")
    record = lineage.fetch_record(t, head)
    check(record is not None and record["replayable"]
          and len(record["contributions"]) == 4,
          f"the weighted round's record: {record}")
    template = _wire_template(gpt2.make_model(cfg)[0])
    # the replay: counts to 0 just before, read just after
    torch.cuda.synchronize()
    _zero_counts()
    dsc.launches = 0
    t0 = time.perf_counter()
    out = lineage.replay_record(t, record, template, parent=tree,
                                device=DEV)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    check(out.ok and out.max_abs_diff <= 1e-6,
          f"replay: max |replayed - published| {out.max_abs_diff}")
    replay_launches = {"dequant_scatter": dsc.launches, **fa.launches}
    check(dsc.launches == 3 and not any(fa.launches.values()),
          f"the replay's launches: {replay_launches}")
    chain_recs = lineage.walk_chain(t, head)
    check(len(chain_recs) == 2 and chain_recs[-1]["strategy"] == "genesis",
          f"walk_chain: {[r['revision'] for r in chain_recs]}")
    # one byte changed: loud
    rid = tbase.lineage_id(head)
    data = t.fetch_delta_bytes(rid)
    i = data.index(b'"round": ') + len(b'"round": ')
    t.publish_raw(rid, data[:i] + bytes([data[i] ^ 1]) + data[i + 1:])
    try:
        lineage.fetch_record(t, head)
        tampered = "accepted"
    except lineage.LineageError:
        tampered = "LineageError"
    t.publish_raw(rid, data)
    check(tampered == "LineageError", "a changed record was accepted")
    return {"cli": {"argv": run["argv"], "rc": run["rc"], "s": run["s"],
                    "launches": run["launches"]},
            "record_id": record["record_id"],
            "weights": [c["weight"] for c in record["contributions"]],
            "replay_max_abs_diff": out.max_abs_diff, "replay_s": replay_s,
            "replay_launches": replay_launches,
            "chain": len(chain_recs), "tampered": tampered}


# the slice-5 phase (20): signed miners, the tree under the outer merge,
# a stood-down round, the standby and a signing validator
S5_STEPS = 3
S5_NODES = ("n0", "n1")
S5_ROOT, S5_STANDBY, S5_RIVAL = "hotkey_95", "hotkey_98", "hotkey_99"
# plan_fanout over the local metagraph (hotkeys sorted as strings) gives
# n0 hotkey_2, 4, 6 and n1 hotkey_1, 3, 5
S5_PLAN = {"n0": ("hotkey_2", "hotkey_4", "hotkey_6"),
           "n1": ("hotkey_1", "hotkey_3", "hotkey_5")}
S5_PACKED = {"n0": 2, "n1": 1}    # packed contributions each sub folds
# the JAX package's verdicts (distributedtraining_tpu/signing.py,
# transport/signed.py), which the port's must equal
JAX_FORGERY_VERDICT = ("envelope public key does not match the hotkey's "
                       "registered key")
JAX_ROLLBACK_VERDICT = "replayed stale base"


class _LogTap:
    """Collects the messages one logger emits (the signed transport's
    verdicts) while the role CLIs run."""

    def __init__(self, name: str):
        import logging
        self.messages: list[str] = []
        self._logger = logging.getLogger(name)
        tap = self

        class _H(logging.Handler):
            def emit(self, record):
                tap.messages.append(record.getMessage())

        self._handler = _H()

    def __enter__(self):
        self._logger.addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self._handler)


def _s5_signing_costs(tree, work: str) -> dict:
    """Ed25519 sign and verify ms on the host, and what signing adds to a
    498 MB base publish and fetch (a plain and a signed LocalFS root)."""
    from distributedtraining_tpu_torch.engine.train import _wire_template
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.transport import (LocalFSTransport,
                                                         SignedTransport)
    from distributedtraining_tpu_torch.utils.identity import Identity
    ident = Identity.from_private_bytes(bytes(range(32)))
    msg = b"delta:hotkey_1" + bytes(32)
    t0 = time.perf_counter()
    sigs = [ident.sign(msg) for _ in range(20)]
    sign_ms = (time.perf_counter() - t0) / 20 * 1e3
    t0 = time.perf_counter()
    ok = all(ident.verify(msg, s) for s in sigs)
    verify_ms = (time.perf_counter() - t0) / 20 * 1e3
    check(ok, "a signature did not verify")
    template = _wire_template(gpt2.make_model(gpt2.PRESETS["gpt2-124m"])[0])
    plain = LocalFSTransport(os.path.join(work, "plain"))
    signed = SignedTransport(LocalFSTransport(os.path.join(work, "signed")),
                             identity=ident, my_hotkey="hotkey_95")
    out = {}
    for name, t in (("plain", plain), ("signed", signed)):
        t0 = time.perf_counter()
        t.publish_base(tree)
        out[f"{name}_publish_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = t.fetch_base(template)
        out[f"{name}_fetch_s"] = time.perf_counter() - t0
        check(got is not None and _bit_equal_trees(got[0], tree),
              f"the {name} base does not read back")
        del got
    return {"ed25519_sign_ms": sign_ms, "ed25519_verify_ms": verify_ms,
            **out,
            "signed_publish_adds_s": out["signed_publish_s"]
            - out["plain_publish_s"],
            "signed_fetch_adds_s": out["signed_fetch_s"]
            - out["plain_fetch_s"]}


def _s5_watch(watch: _Watch) -> None:
    """Phase 20's hooks, added to phase 19's (``watch`` undoes them)."""
    from distributedtraining_tpu_torch import delta
    from distributedtraining_tpu_torch.engine import average, basedist
    from distributedtraining_tpu_torch.engine.remediate import \
        StandbyAverager
    from distributedtraining_tpu_torch.engine.validate import Validator
    from distributedtraining_tpu_torch.transport import SignedTransport

    def cpu(tree):
        return {k: v.detach().cpu().clone() for k, v in tree.items()}

    # the encoders' inputs and outputs, off the card (the byte check)
    for name in ("quantize_delta", "sparsify_delta"):
        watch._wrap(delta, name, lambda d, a, out, s: {
            "delta": cpu(d), "s": s})
    watch._wrap(basedist.MirrorDuty, "sync", lambda m, a, out, s: {
        "ok": out, "s": s, **(m.last_sync or {})})
    watch._wrap(average.OuterOptMerge, "merge", lambda o, a, out, s: {
        "base": cpu(a[1]), "deltas": list(a[2]), "ids": list(a[3]),
        "w": cpu(out[1]), "pending": cpu(o._pending_velocity), "s": s})
    watch._wrap(average.OuterOptMerge, "commit", lambda o, a, out, s: {
        "t": time.time(), "s": s, "bytes": sum(
            v.numel() * v.element_size() for v in o.velocity.values())})
    watch._wrap(SignedTransport, "publish_base", lambda st, a, out, s: {
        "t": time.time(), "s": s, "rev": out, "by": st.my_hotkey})
    watch._wrap(StandbyAverager, "poll_once", lambda sb, a, out, s: {
        "t": time.time(), "state": out, "epoch": sb.lease.epoch})
    watch._wrap(Validator, "validate_and_score", lambda v, a, out, s: {
        "scores": {r.hotkey: (r.score, r.reason) for r in out}, "s": s})


def phase_slice5(tree, tok) -> dict:
    """Slice 5 through the role CLIs at GPT-2-124M full width and depth
    on a fresh LocalFS root, every role with --sign-artifacts: signed
    int8, sparse8 and wire-v2 miners, two --hier sub nodes with mirrors,
    a --hier root under --outer-momentum, a round whose lease stands
    down, a --standby takeover and a signing validator."""
    import hashlib
    import importlib.util
    import tempfile
    import threading
    import torch
    from distributedtraining_tpu_torch import delta
    from distributedtraining_tpu_torch import serialization as ser
    from distributedtraining_tpu_torch import signing
    from distributedtraining_tpu_torch.chain import (LocalAddressStore,
                                                     LocalChain)
    from distributedtraining_tpu_torch.engine.average import (
        AveragerLoop, OuterOptMerge, ParameterizedMerge)
    from distributedtraining_tpu_torch.engine.basedist import BaseFetcher
    from distributedtraining_tpu_torch.engine.publish import host_materialize
    from distributedtraining_tpu_torch.engine.remediate import (
        LeaseManager, parse_lease)
    from distributedtraining_tpu_torch.engine.train import (TrainEngine,
                                                            _wire_template)
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.neurons import averager as avg_cli
    from distributedtraining_tpu_torch.neurons import miner as miner_cli
    from distributedtraining_tpu_torch.neurons import validator as val_cli
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.transport import (LocalFSTransport,
                                                         SignedTransport)
    from distributedtraining_tpu_torch.transport import base as tbase
    from distributedtraining_tpu_torch.utils.identity import Identity
    cfg = gpt2.PRESETS["gpt2-124m"]
    L = cfg.n_layer
    template = _wire_template(gpt2.make_model(cfg)[0])
    res: dict = {"model": "gpt2-124m", "cryptography_present":
                 importlib.util.find_spec("cryptography") is not None}
    runs: dict = {}
    with tempfile.TemporaryDirectory() as work, _Watch() as watch, \
            _LogTap("distributedtraining_tpu_torch.transport.signed") as tap:
        _s5_watch(watch)
        res["signing"] = _s5_signing_costs(tree, os.path.join(work, "cost"))
        arts = os.path.join(work, "artifacts")
        t = LocalFSTransport(arts)
        store = LocalAddressStore(os.path.join(work, "chain"))
        common = DEFAULT_FLAGS + ["--work-dir", work, "--sign-artifacts",
                                  "--base-signer", S5_ROOT]
        tree_flags = ["--hier-nodes", ",".join(S5_NODES)]
        root_flags = common + tree_flags + [
            "--hier", "root", "--outer-momentum", "0.9", "--hotkey",
            S5_ROOT, "--rounds", "1", "--publish-policy", "always"]

        def reader(signer=S5_ROOT):
            return SignedTransport(LocalFSTransport(arts),
                                   pubkey_resolver=store.retrieve_pubkey,
                                   base_signer=signer)

        def wallet(hotkey):
            return Identity.load(os.path.join(work, "wallets",
                                              f"{hotkey}.json"))

        # genesis by the root (no aggregates yet: exit 1, a signed base)
        g = _cli(avg_cli, root_flags, watch)
        check(g["rc"] == 1 and t.base_revision() is not None,
              f"the root's genesis run exited {g['rc']}")
        b0 = t.base_revision()
        b0_bytes = t.fetch_base_bytes()
        check(signing.is_enveloped(b0_bytes), "the genesis base is unsigned")
        runs["root_genesis"] = g
        # 1. signed miners: int8 with the fused loss, sparse8, wire-v2
        m_flags = common + ["--max-steps", str(S5_STEPS),
                            "--checkpoint-interval", "0",
                            "--no-anomaly-trace"]
        miners = {"hotkey_1": ["--delta-dtype", "int8", "--fused-loss"],
                  "hotkey_2": ["--delta-dtype", "sparse8"],
                  "hotkey_3": ["--wire-v2"]}
        for h, extra in miners.items():
            r = _cli(miner_cli, m_flags + extra + ["--hotkey", h], watch)
            check(r["rc"] == 0, f"miner {h} exited {r['rc']}")
            _check_launches(f"miner {h}", r["launches"], _train_want(
                cfg, S5_STEPS, fused="--fused-loss" in extra))
            runs[h] = r
        # the encoders' artifacts against the plain encoders on CPU copies
        codec = {}
        for h, name, fn in (
                ("hotkey_1", "quantize_delta", delta.quantize_delta),
                ("hotkey_2", "sparsify_delta",
                 lambda d: delta.sparsify_delta(d, density=1 / 64))):
            # the artifact on the root is the last push's
            seen = runs[h]["seen"][name]
            check(len(seen) >= 1, f"{h} encoded no push")
            want = ser.to_msgpack(host_materialize(fn(seen[-1]["delta"])))
            got = signing.strip_envelope(t.fetch_delta_bytes(h))
            check(got == want, f"{h}'s {name} artifact differs from the "
                               "plain encoder's bytes on the CPU copy")
            codec[h] = {"bytes": len(got), "encode_s": seen[-1]["s"],
                        "pushes": len(seen)}
        # two more packed contributions, signed by their own wallets
        g_noise = torch.Generator(device=DEV).manual_seed(SEED + 20)
        shapes = {k: v.shape for k, v in gpt2.params_from_numpy(
            tree, device=DEV).items()}
        for h, quant in (("hotkey_4", "int8"), ("hotkey_6", "none")):
            ident = Identity.generate()
            store.store_pubkey(h, ident.public_bytes)
            _publish_packed(SignedTransport(
                LocalFSTransport(arts), identity=ident, my_hotkey=h), h,
                {k: torch.randn(s, generator=g_noise, device=DEV) * 1e-5
                 for k, s in shapes.items()}, b0, quant)
        # the forgery: under hotkey_5's id (its key registered), signed
        # by hotkey_1's key
        store.store_pubkey("hotkey_5", Identity.generate().public_bytes)
        t.publish_raw("hotkey_5", signing.wrap(
            ser.to_msgpack(gpt2.params_to_numpy(
                {k: torch.zeros(s) for k, s in shapes.items()})),
            wallet("hotkey_1"), signing.delta_context("hotkey_5")))
        rd = reader()
        for h in ("hotkey_1", "hotkey_2", "hotkey_3", "hotkey_4",
                  "hotkey_6"):
            raw = t.fetch_delta_bytes(h)
            check(signing.is_enveloped(raw) and rd.fetch_delta_bytes(h)
                  is not None, f"{h}'s artifact is not enveloped or fails "
                               "its signature")
        try:
            signing.unwrap(t.fetch_delta_bytes("hotkey_5"),
                           signing.delta_context("hotkey_5"),
                           expected_pub=store.retrieve_pubkey("hotkey_5"))
            forgery = "accepted"
        except ser.PayloadError as e:
            forgery = str(e)
        check(forgery == JAX_FORGERY_VERDICT,
              f"the forgery's verdict: {forgery!r}")
        check(rd.fetch_delta_bytes("hotkey_5") is None,
              "the signed transport read the forgery")
        res["miners"] = {h: {"rc": r["rc"], "s": r["s"],
                             "hook_s": r["hook_s"], "flags": miners[h],
                             "launches": r["launches"], **codec.get(h, {})}
                         for h, r in runs.items() if h in miners}
        res["forgery_verdict"] = forgery
        # 2. the tree: two subs (n1 on the v2 wire), each with its mirror
        subs = {}
        for node, hk, extra in (("n0", "hotkey_96", []),
                                ("n1", "hotkey_97", ["--hier-wire-v2"])):
            r = _cli(avg_cli, common + tree_flags + extra + [
                "--hier", "sub", "--hier-node", node, "--hotkey", hk,
                "--rounds", "1"], watch)
            check(r["rc"] == 0, f"sub {node} exited {r['rc']}")
            _check_launches(f"sub {node}", r["launches"],
                            {"dequant_scatter": S5_PACKED[node]})
            meta = t.fetch_delta_meta(tbase.agg_id(node))
            check(meta["agg"]["miners"] == len(S5_PLAN[node]) - (
                node == "n1") and meta["base_revision"] == b0,
                  f"sub {node}'s rider {meta}")
            mir = r["seen"]["sync"]
            check(len(mir) == 1 and mir[0]["ok"]
                  and mir[0]["shards"] == WIRE_LEAVES,
                  f"sub {node}'s mirror sync {mir}")
            pres = t.fetch_delta_meta(tbase.mirror_node_id(node))
            check(pres == {"mirror": {"revision": b0,
                                      "layers": WIRE_LEAVES}},
                  f"mirror {node}'s presence rider {pres}")
            subs[node] = r
        check(signing.is_enveloped(t.fetch_delta_bytes(
            tbase.agg_id("n0"))) and signing.is_enveloped(
            t.fetch_delta_bytes(tbase.agg_id("n1"))),
              "an aggregate is not enveloped")
        man = _manifest_signed(t, b0)
        for node in S5_NODES:
            for key, info in man["layers"].items():
                data = tbase.fetch_shard(t, tbase.mirror_node_id(node), key)
                check(data is not None and ser.shard_digest(data)
                      == info["h"], f"mirror {node} lacks shard {key}")
        # a fetcher of the genesis base reads it off the mirrors
        f = BaseFetcher(reader())
        t0 = time.perf_counter()
        got = f.fetch(template)
        mirror_fetch_s = time.perf_counter() - t0
        mono = reader().fetch_base(template)
        check(got is not None and got[1] == b0 and f.fallbacks_total == 0
              and f.mirror_hits_total == f.network_shards_total > 0
              and _bit_equal_trees(got[0], mono[0]),
              f"the mirrored fetch: hits {f.mirror_hits_total} of "
              f"{f.network_shards_total}, fallbacks {f.fallbacks_total}")
        del got, mono
        res["subs"] = {n: {"rc": r["rc"], "s": r["s"],
                           "hook_s": r["hook_s"],
                           "launches": r["launches"],
                           "mirror_sync_s": r["seen"]["sync"][0]["s"],
                           "mirror_sync_bytes":
                               r["seen"]["sync"][0]["bytes"]}
                       for n, r in subs.items()}
        res["mirror_fetch"] = {"s": mirror_fetch_s,
                               "mirror_hits": f.mirror_hits_total,
                               "store_hits": f.store_hits_total}
        # the root under the outer merge
        vpath = os.path.join(work, "averager_state",
                             f"velocity_{S5_ROOT}.msgpack")
        check(not os.path.exists(vpath), "a velocity before the first merge")
        r = _cli(avg_cli, root_flags, watch)
        check(r["rc"] == 0 and t.base_revision() != b0,
              f"the root exited {r['rc']} without a new base")
        runs["root"] = r
        b1 = t.base_revision()
        fwd = r["launches"]["flash_attention_fwd"]
        n_b, rest = divmod(fwd, L * 8)     # 7 epochs + the merged eval
        check(n_b > 0 and rest == 0, f"root flash fwd launches {fwd}")
        _check_launches("root", r["launches"], {
            "flash_attention_fwd": L * 8 * n_b,
            "flash_attention_bwd_dkv": L * 7 * n_b,
            "flash_attention_bwd_dq": L * 7 * n_b})
        merge = r["seen"]["merge"][-1]
        check(merge["ids"] == [tbase.agg_id(n) for n in S5_NODES],
              f"the root merged {merge['ids']}")
        pubs = [p for p in r["seen"]["publish_base"] if p["rev"] == b1]
        commits = r["seen"]["commit"]
        check(len(pubs) == 1 and len(commits) == 1
              and commits[0]["t"] >= pubs[0]["t"] and os.path.exists(vpath),
              "the velocity was not committed after the publish")
        # base + outer_lr (m v + d), v = d (zero before), by the plain
        # versions on the CPU
        base = merge["base"]
        placed = [delta.place_delta(d, base) for d in merge["deltas"]]
        mix = delta.per_tensor_weighted_merge(
            base, placed, {k: torch.softmax(x, dim=0)
                           for k, x in merge["w"].items()})
        want_v = {k: mix[k] - base[k] for k in base}
        want = {k: base[k] + 0.7 * (0.9 * want_v[k] + want_v[k])
                for k in base}
        del placed, mix
        pub = gpt2.params_from_numpy(reader().fetch_base(template)[0],
                                     device="cpu")
        base_err = max(float((pub[k] - want[k]).abs().max()) for k in pub)
        vfile = delta.flatten_tree(ser.load_file(vpath, template))
        v_err = max(float((torch.tensor(vfile[k]) - want_v[k]).abs().max())
                    for k in want_v)
        check(base_err <= 1e-6 and v_err <= 1e-6,
              f"the outer step vs the plain versions: base {base_err}, "
              f"velocity {v_err}")
        del pub, want, want_v, vfile, base, merge
        # a replayed stale base (the genesis envelope) is refused
        seen_reader = reader()
        check(seen_reader.fetch_base(template) is not None,
              "the root's base does not verify")
        b1_bytes = t.fetch_base_bytes()
        t.publish_base_raw(b0_bytes)
        n_tap = len(tap.messages)
        check(seen_reader.fetch_base(template) is None,
              "a replayed stale base was accepted")
        rollback = [m for m in tap.messages[n_tap:]
                    if JAX_ROLLBACK_VERDICT in m]
        check(rollback, f"no rollback verdict: {tap.messages[n_tap:]}")
        t.publish_base_raw(b1_bytes)
        check(t.base_revision() == b1, "the base did not come back")
        del b0_bytes, b1_bytes
        res["root"] = {"rc": r["rc"], "s": r["s"], "hook_s": r["hook_s"],
                       "launches": r["launches"], "eval_batches": n_b,
                       "aggregates": len(S5_NODES),
                       "published_vs_plain_max_abs": base_err,
                       "velocity_vs_plain_max_abs": v_err,
                       "velocity_device_bytes": commits[0]["bytes"],
                       "velocity_save_s": commits[0]["s"],
                       "signed_publish_s": pubs[0]["s"],
                       "outer_merge_s": r["seen"]["merge"][-1]["s"],
                       "rollback_verdict": rollback[0]}
        # 3. a round whose lease another holder takes first: merged, not
        # published, and the velocity file keeps its bytes
        with open(vpath, "rb") as fh:
            v_digest = hashlib.sha256(fh.read()).hexdigest()
        model = gpt2.make_model(cfg)[0]
        root_t = SignedTransport(LocalFSTransport(arts),
                                 identity=wallet(S5_ROOT),
                                 pubkey_resolver=store.retrieve_pubkey,
                                 base_signer=S5_ROOT, my_hotkey=S5_ROOT)
        lease = LeaseManager(LocalFSTransport(arts), S5_ROOT)
        check(lease.acquire(), "the root could not take the lease")
        outer = OuterOptMerge(ParameterizedMerge(model), outer_lr=0.7,
                              momentum=0.9, state_path=vpath)
        held = _batches(tok, split="test", batch_size=MINER_B,
                        seq_len=EVAL_T, n=n_b)
        loop = AveragerLoop(TrainEngine(model, device=DEV), root_t,
                            LocalChain(os.path.join(work, "chain"),
                                       my_hotkey=S5_ROOT), outer,
                            val_batches=lambda: iter(held),
                            publish_policy="always", stale_deltas="accept",
                            hierarchy=list(S5_NODES), lease=lease)
        loop.bootstrap()
        rival = LeaseManager(LocalFSTransport(arts), S5_RIVAL)
        check(rival.acquire() and rival.epoch == lease.epoch + 1,
              "the rival did not take the next epoch")
        restored = None
        torch.cuda.synchronize()
        _zero_counts()
        dsc.launches = 0
        t0 = time.perf_counter()
        merged = loop.run_round()
        torch.cuda.synchronize()
        down_s = time.perf_counter() - t0
        down_launches = {"dequant_scatter": dsc.launches, **fa.launches,
                         **fused_ce.launches}
        restored = {k: v.detach().cpu() for k, v in outer.velocity.items()}
        loop.close()
        with open(vpath, "rb") as fh:
            v_after = hashlib.sha256(fh.read()).hexdigest()
        vfile = delta.flatten_tree(ser.load_file(vpath, template))
        check(merged and loop.report.skipped_publishes == 1
              and t.base_revision() == b1 and v_after == v_digest
              and outer._pending_velocity is not None
              and all(torch.equal(torch.tensor(vfile[k]), restored[k])
                      for k in restored),
              "the stood-down round moved the base or the velocity")
        _check_launches("stood-down round", down_launches, {
            "flash_attention_fwd": L * 8 * n_b,
            "flash_attention_bwd_dkv": L * 7 * n_b,
            "flash_attention_bwd_dq": L * 7 * n_b})
        res["stand_down"] = {"s": down_s, "launches": down_launches,
                             "velocity_sha256": v_after,
                             "rival_epoch": rival.epoch}
        del loop, outer, restored, vfile, model
        gc.collect()
        # 4. the standby: passive while the primary renews, then epoch + 1
        primary = LeaseManager(LocalFSTransport(arts), S5_ROOT)
        check(primary.acquire(), "the primary could not take the lease")
        renewals: list[float] = []
        stop = threading.Event()

        def renew():
            # until the standby has seen three renewals go by
            while not stop.is_set():
                polls = watch.seen.get("poll_once", [])
                if sum(p["state"] == "following" for p in polls) >= 4:
                    return
                if primary.renew():
                    renewals.append(time.time())
                stop.wait(0.3)

        th = threading.Thread(target=renew, daemon=True)
        th.start()
        try:
            sb = _cli(avg_cli, common + [
                "--standby", "--failover-deadline", "2",
                "--averaging-interval", "4", "--strategy", "weighted",
                "--stale-deltas", "accept", "--publish-policy", "always",
                "--hotkey", S5_STANDBY, "--rounds", "1"], watch)
        finally:
            stop.set()
            th.join()
        polls = sb["seen"]["poll_once"]
        states = [p["state"] for p in polls]
        take = polls[-1]
        check(sb["rc"] == 0 and states[-1] == "takeover"
              and all(s == "following" for s in states[:-1])
              and len(renewals) >= 2
              and take["t"] - renewals[-1] >= 2.0,
              f"the standby: rc {sb['rc']}, polls {states}, renewals "
              f"{len(renewals)}")
        token = parse_lease(t.fetch_delta_meta(tbase.lease_id()))
        primary_epoch = primary.epoch
        b2 = t.base_revision()
        sb_pubs = sb["seen"]["publish_base"]
        check(token["holder"] == S5_STANDBY
              and token["epoch"] == primary.epoch + 1
              and token["base_revision"] == b2 != b1
              and len(sb_pubs) == 1 and sb_pubs[0]["by"] == S5_STANDBY,
              f"the takeover: token {token}, publishes {sb_pubs}")
        check(reader(S5_STANDBY).fetch_base(template) is not None
              and signing.is_enveloped(t.fetch_base_bytes()),
              "the standby's base is not signed by it")
        check(not primary.renew(), "the old primary still holds the lease")
        fwd = sb["launches"]["flash_attention_fwd"]
        _check_launches("standby", sb["launches"], {
            "dequant_scatter": 3, "flash_attention_fwd": L * n_b})
        res["standby"] = {"rc": sb["rc"], "s": sb["s"],
                          "hook_s": sb["hook_s"],
                          "launches": sb["launches"], "polls": states,
                          "renewals": len(renewals),
                          "takeover_after_last_renewal_s":
                              take["t"] - renewals[-1],
                          "epoch": token["epoch"],
                          "primary_epoch": primary_epoch}
        runs["standby"] = sb
        # 5. a signing validator scores the signed fleet
        n_tap = len(tap.messages)
        v = _cli(val_cli, common[:-2] + ["--base-signer", S5_STANDBY,
                                         "--hotkey", "hotkey_91",
                                         "--rounds", "1"], watch)
        check(v["rc"] == 0, f"the validator exited {v['rc']}")
        scores = v["seen"]["validate_and_score"][-1]["scores"]
        honest = ("hotkey_1", "hotkey_2", "hotkey_3")
        check(all(scores[h][0] > 0 and scores[h][1] == "ok" for h in honest),
              f"honest scores {[scores[h] for h in honest]}")
        check(scores["hotkey_5"] == (0.0, "no_delta") and any(
            "hotkey_5" in m and JAX_FORGERY_VERDICT in m
            for m in tap.messages[n_tap:]),
              f"the forgery scored {scores['hotkey_5']}")
        ok = [h for h, (_, why) in scores.items() if why == "ok"]
        _check_launches("validator", v["launches"], {
            "flash_attention_fwd": L * n_b * (len(ok) + 1)})
        res["validator"] = {"rc": v["rc"], "s": v["s"],
                            "hook_s": v["hook_s"],
                            "launches": v["launches"],
                            "scores": {h: scores[h] for h in
                                       (*honest, "hotkey_4", "hotkey_5",
                                        "hotkey_6")}}
        runs["validator"] = v
        runs.update(subs)
    res["root_genesis_s"] = runs["root_genesis"]["s"]
    keys = runs["root"]["launches"]
    res["launches"] = {k: sum(r["launches"][k] for r in runs.values())
                       + down_launches[k] for k in keys}
    log("slice5:", json.dumps(res))
    return res


def _manifest_signed(t, rev) -> dict:
    """A signed revision's manifest (the envelope stripped)."""
    from distributedtraining_tpu_torch import serialization as ser
    from distributedtraining_tpu_torch import signing
    from distributedtraining_tpu_torch.transport import base as tbase
    data = tbase.fetch_base_manifest_bytes(t, rev)
    check(data is not None and signing.is_enveloped(data),
          f"the manifest of {rev} is not enveloped")
    man = ser.parse_base_manifest(signing.strip_envelope(data))
    check(man is not None and man["revision"] == rev
          and len(man["layers"]) == WIRE_LEAVES,
          f"the manifest of {rev}: {man and len(man['layers'])} layers")
    return man


def _scatter_entry(scatter: dict, avg: dict, build: dict,
                   defaults: dict, slice5: dict) -> dict:
    wte, whole = scatter["timed"]["wte"], scatter["timed"]["contribution"]
    replaces, tpu = SCATTER_TPU
    return {
        "name": "dequant_scatter", "route": "cuda",
        "source": SCATTER_SOURCE, "replaces": replaces, "tpu_kernel": tpu,
        # the averager's round 1, the slice's main path
        "launches": avg["round1"]["launches"]["dequant_scatter"],
        # phase 19: the weighted round's merge and its lineage replay
        "launches_defaults": defaults["launches"]["dequant_scatter"],
        # phase 20: the sub-averagers' folds and the standby's round
        "launches_slice5": slice5["launches"]["dequant_scatter"],
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


FLASH_KERNELS = {"flash_attention_fwd": "flash_fwd_mma_kernel",
                 "flash_attention_bwd_dkv": "flash_bwd_dkv_mma_kernel",
                 "flash_attention_bwd_dq": "flash_bwd_dq_mma_kernel"}


def _flash_entries(flash: dict, train: dict, build: dict, val: dict,
                   meta: dict, defaults: dict, slice5: dict) -> list:
    out = []
    per = build["sources"]["flash_attention"]["kernels"]
    for name, tpu in FLASH_TPU_KERNELS.items():
        keys = ("o", "lse") if name == "flash_attention_fwd" else (
            ("dk", "dv") if name.endswith("dkv") else ("dq",))
        # and against the plain version of the kernels' walk
        keys += tuple(f"{key}_tiled" for key in keys
                      if key not in ("o", "lse"))
        checks = flash["checks"]
        out.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": "distributedtraining_tpu/ops/flash_attention.py:86",
            "tpu_kernel": tpu,
            "launches": train["launches"][name],
            # the validator's round and the meta merge's round
            "launches_validator": val["round"]["launches"][name],
            "launches_meta_merge": meta["launches"][name],
            # phase 19, the role CLIs with the JAX defaults
            "launches_defaults": defaults["launches"][name],
            # phase 20, slice 5's CLIs (and the stood-down round)
            "launches_slice5": slice5["launches"][name],
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
            # ptxas's registers and spill bytes, D 64 and D 128 (the bf16
            # kernel's instantiations, by mangled name)
            "registers": [v for k, v in per.items()
                          if FLASH_KERNELS[name] in k],
            "timed_shape": flash["timed_shape"],
            "build_s": build["build_s"]})
    return out


def _ce_registers(build: dict) -> dict:
    """ptxas's registers and spill bytes of the bf16 backward's kernels
    (every instantiation whose mangled name holds the kernel's)."""
    per = build["sources"]["fused_ce"]["kernels"]
    return {k: [v for name, v in per.items() if k in name]
            for k in CE_BWD_KERNELS}


def _ce_entries(ce: dict, miner: dict, tfused: dict, build: dict,
                defaults: dict, slice5: dict) -> list:
    out = []
    regs = _ce_registers(build)
    for name, (replaces, tpu) in CE_TPU_KERNELS.items():
        keys = CE_OUTPUTS[name]
        checks = ce["checks"]
        at = ce["timed"][name]
        big, small = (at[k] for k in sorted(
            (k for k in at if "_e" not in k), key=lambda k: -int(k[1:])))
        wide = next((v for k, v in at.items() if k.endswith("_e1280")), {})
        # the backward entry counts one dh and one dW launch a call
        counter = "fused_ce_bwd_dh" if name == "fused_ce_bwd" else name
        out.append({
            "name": name, "route": "cuda", "source": CE_SOURCE,
            "replaces": replaces, "tpu_kernel": tpu,
            # the miner's round, the slice's main path
            "launches": miner["launches"][counter],
            "launches_train_fused": tfused["launches"][counter],
            "launches_defaults": defaults["launches"][counter],
            # phase 20: the --fused-loss int8 miner
            "launches_slice5": slice5["launches"][counter],
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
            "max_rel_err_bf16_e1280": max(
                c["err"][k] for c in checks for k in keys
                if c["E"] > 1024 and k in c["err"]),
            **big,
            **{f"{k}_e1280": v for k, v in wide.items()},
            "ms_n504": small["ms"],
            **({"ms_n504_one_split": small["ms_one_split"]}
               if "ms_one_split" in small else {}),
            "plain_ms_n504": small["plain_ms"],
            "library_ms_n504": small["library_ms"],
            "bound_ms_n504": small["bound_ms"],
            **({"plan_n504": small["plan"]} if "plan" in small else
               {"splits_n504": small["splits"]}),
            **({"registers": regs} if name != "fused_ce_fwd" else {}),
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
    import tempfile
    with tempfile.TemporaryDirectory() as work:
        avg = phase_averager(tree, tok, work)
        t0 = time.perf_counter()
        val = phase_validator(tree, tok, work)
        meta = phase_meta_merge(tree, tok, work)
        val_meta_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    defaults = phase_defaults(tree, tok)
    defaults["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    slice5 = phase_slice5(tree, tok)
    slice5["s"] = time.perf_counter() - t0
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
        "ms": kern["kernel_ms"], "host_ms": kern["host_ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
        "long_ctx_4096": kern["long_ctx_4096"],
        "decode_step_device_ms": prof["device_ms_per_step"],
        "decode_step_paged_ms": prof["paged_decode_ms_per_step"],
        "timed_shape": kern["timed_shape"],
        "build_s": build["build_s"]},
        *_flash_entries(flash, train, build, val, meta, defaults, slice5),
        *_ce_entries(ce, miner, tfused, build, defaults, slice5),
        _scatter_entry(scatter, avg, build, defaults, slice5)]}),
        flush=True)
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
    print(json.dumps({"validator": {**val, "meta_merge": meta,
                                    "phases_17_18_s": val_meta_s,
                                    "card": card}}), flush=True)
    print(json.dumps({"defaults": {**defaults, "card": card}}), flush=True)
    total_s = time.perf_counter() - t_start
    print(json.dumps({"slice5": {**slice5, "card": card,
                                 "total_s": total_s}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def decode_ab(runs: int) -> int:
    """One side of a decode-path comparison (``--decode-ab N``)."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.ops import paged_attention as pa
    s = dict(B=8, Hq=12, Hkv=12, D=64, P=16, MP=64,
             lens=[0, 15, 16, 17, 1023, 1024, 300, 777])
    args = _decode_case(s["B"], s["Hq"], s["Hkv"], s["D"], s["P"], s["MP"],
                        s["lens"], torch.bfloat16, SEED)
    out = pa.paged_decode_attention(*args)
    err = float((out.float() - pa.paged_decode_reference(*args).float())
                .abs().max())
    check(err <= 2e-2, f"paged decode kernel vs plain version: {err}")
    print(json.dumps({"decode_ab": {
        "root": ROOT, "paged_ms": _time_ms(
            lambda: pa.paged_decode_attention(*args)),
        "paged_host_ms": _host_ms(lambda: pa.paged_decode_attention(*args)),
        "max_abs_err": err, "card": card}}), flush=True)
    tree = gpt2.init_params_numpy(gpt2.PRESETS["gpt2-124m"], SEED)
    for i in range(runs):
        r = phase_serve(tree)
        print(json.dumps({"decode_ab_serve": {
            "root": ROOT, "run": i, **{k: r[k] for k in (
                "tpot_ms_p50", "tpot_ms_p95", "ttft_ms_p50", "step_ms_p50",
                "tokens_per_s", "wall_s", "kernel_launches",
                "decode_dispatches")}}}), flush=True)
    return 0


def flash_ab(runs: int) -> int:
    """One side of a flash-attention comparison (``--flash-ab N``)."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    from distributedtraining_tpu_torch.models import gpt2
    phase_build()
    tok = _tokenizer()
    seg = _batches(tok, split="train", batch_size=TRAIN_B, seq_len=TRAIN_T,
                   n=1)[0]["segment_ids"]
    tree = gpt2.init_params_numpy(gpt2.PRESETS["gpt2-124m"], SEED)
    for i in range(runs):
        res = _flash_timing(seg)
        prof = phase_train_profile(tree, tok, fused=True)
        print(json.dumps({"flash_ab": {
            "root": ROOT, "run": i, **res,
            "fused_step_device_ms": prof["device_ms_per_step"],
            "fused_step_flash_ms": prof["flash_ms_per_step"],
            "card": card}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--decode-ab"]:
            sys.exit(decode_ab(int(sys.argv[2])))
        if sys.argv[1:2] == ["--flash-ab"]:
            sys.exit(flash_ab(int(sys.argv[2])))
        sys.exit(main())
    except SmokeFailure as e:
        log(f"chip_smoke: FAIL: {e}")
        sys.exit(1)
    except Exception:
        log("chip_smoke: FAIL with an exception:")
        traceback.print_exc()
        sys.exit(1)
