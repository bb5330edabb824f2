#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (distributedtraining_tpu_torch) on one
NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --decode-ab N
    python3 chip_smoke.py --flash-ab N
    python3 chip_smoke.py --window-ab N
    python3 chip_smoke.py --serve6b
    python3 chip_smoke.py --parallel
    python3 chip_smoke.py --parallel-cards
    python3 chip_smoke.py --tp-ab DIR [DIR ...]
    python3 chip_smoke.py --mesh-roles
    python3 chip_smoke.py --sp
    python3 chip_smoke.py --llama
    python3 chip_smoke.py --llama-train
    python3 chip_smoke.py --lora
    python3 chip_smoke.py --lora-soak STEPS [--checked]
    python3 chip_smoke.py --convert
    python3 chip_smoke.py --health
    python3 chip_smoke.py --beat-ab [ROUNDS [CLI_PAIRS]]
    python3 chip_smoke.py --devprof-ab [ROUNDS [CLI_PAIRS]]
    python3 chip_smoke.py --obs
    python3 chip_smoke.py --phase-times OUT DIR [DIR ...]

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
JSON line each. ``--window-ab N`` is the same for the paged window
kernel: N times, phase 21's window timings (``_time_ms``, the profiler's
device time and the host time of the wrapper beside SDPA's and the
bound, at the verify, a 512-row suffix over 900 positions and a 64-row
one over 512) and phase 21's traffic once through the server CLI, with
the ttft and prefill ms of every request that hit the prefix cache.
``--serve6b`` runs phase 22 alone after the build,
``--parallel`` phase 23 alone, ``--mesh-roles`` phase 24 alone, ``--sp``
phase 25 alone, ``--llama`` phase 26 alone, ``--llama-train`` phase 27
alone, ``--lora`` phase 28 with its full-depth part,
``--lora-soak STEPS`` the full-depth LoRA step of 28c STEPS times (with
``--checked``, the card synchronised before and after each flash and CE
launch and the launch's inputs and outputs checked, so that a fault
names its kernel), ``--convert`` phase 29's ``llama2-7b`` part,
``--health`` phase 30 alone, ``--beat-ab`` a heartbeat's cost
on the miner's step (:func:`beat_ab`), ``--devprof-ab`` the device
observatory's (:func:`devprof_ab`), ``--obs`` phase 31 alone, and ``--parallel-cards`` the worlds of phases 23 and 24
over NCCL on every card of a machine with several (at world 4 with the
sp2 x tp2 and dp2 x sp2 engines too). ``--tp-ab DIR...`` times phase 23's tp
engine steps with the package of each checkout DIR in turn (parent,
change, change, parent): tp 2 on two gloo ranks sharing the card, or
fsdp 2 x tp 2 and tp 4 over NCCL on a machine of four cards or more.
``--phase-times
OUT DIR...`` times the whole script of each checkout DIR in turn on one
machine (parent, change, change, parent for a comparison): each run's
``main()`` with every ``phase_*`` function timed, its output and errors
in OUT, and one JSON line a run with its exit code and the seconds of
each phase call in order.

Phases, each of which fails the run (non-zero exit, no result line):

1. env     CUDA must be available (there is no CPU fallback); prints the
           card's name and power limit, torch/CUDA versions, capability,
           and which of tokenizers, transformers, datasets and g++ the
           machine has.
2. build   compiles every CUDA source under csrc/, one nvcc each, and
           the host packer (native/packing.cpp), all started together;
           reports seconds, registers and spills per kernel (ptxas -v)
           and the packer's compiler.
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
           one 32-tile ballot word, dk/dv's running the other way), and
           a tp rank's heads (H 6 and 3: the local [B, T, 3E/tp]
           projection of phase 23's tp 2 and tp 4 blocks); q, k,
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
21. serve6 the server role. The paged window kernel against its plain
           version and the plain version of its decomposition
           (``paged_window_split_reference``): f32 max abs <= 1e-5; bf16
           per element within 2^-7 |plain| + 1e-4 max |plain| of each,
           which a planted lost 32-row tile exceeds. Cases: the verify's
           shape (W 5, 8 slots, contexts 8-900; and with two padded
           lanes), one query a slot (W 1), the suffix prefill's (one slot,
           W 16, 64, 512 over contexts 0, P - 1, P, P + 1 and 900; W 64
           over 512) and a GQA case (D 128). Timed at the verify's shape,
           at W 512 over 900 context positions and at W 64 over 512
           (bf16) beside its bound, the plain version and SDPA on the
           pre-gathered context with the window's mask: ``_time_ms``, the
           profiler's device time and the wrapper's host time. The sampler's
           threefry bits for 64 keys over GPT-2's vocabulary on the card
           equal the CPU's, and so do its picks on logits without
           near-ties (on random logits the agreement is reported). In f32
           at GPT-2-124M width with the prefix cache, spec-on (a
           self-draft, K 4) and a scripted drafter that is always wrong
           against spec-off: greedy lanes token identical, the scripted
           drafter accepts 0, the sampled lanes' agreement reported (their
           Gumbel noise is indexed by rank: an ulp between the decode and
           the window kernels' logits that swaps two near-equal ranks
           changes the draw). Then ``neurons.server.main`` twice on a
           LocalFS root whose base the port's transport published, with
           the JAX server's defaults (prefix cache and traces on; the
           corpus, tokenizer, port, a 1 s swap poll and a step bound
           given): 8 concurrent requests sharing a 512-token system
           prompt, each with its own suffix, greedy and sampled lanes
           (temperature 0.8, top_p 0.9, distinct seeds), 32 new tokens
           each; first with ``--speculative --draft-k 4`` (self-draft),
           then without, a second base published once tokens flow and
           swapped in under drain (later answers name it). Every request
           done on the boot base, prefix hits >= 7, the pool's refcounts
           equal the cache's holders, and the launches exact: decode ==
           12 x (target decodes + drafter steps), window == 12 x (suffix
           prefills + verifies), flash forward == 12 x (full prefills +
           drafter prefills), nothing else. Reports ttft and tpot p50/p95
           (per request, from the traces), tokens/s, prefix hit rate,
           accept rate and the bf16 spec-on/spec-off agreement.
22. serve6b slice 6b. In f32 (TF32 off) at GPT-2-124M width: a prefill
           worker (prefix cache on) and a decode worker against a unified
           engine on phase 21's traffic (every lane with its own seed):
           every request adopted with no re-prefill, greedy lanes token
           identical, and each request's first differing token a near-tie
           by phase 21's rule (the rows must not rank the kept tokens
           alike, and the winner's logit gap is within twice the rows'
           max |logit difference|). Then, on one LocalFS root, a
           ``--serve-phase prefill`` and a ``--serve-phase decode``
           ``neurons.server.main`` and a unified one (bf16, the JAX
           defaults), with ``neurons.router.main`` in front of the three:
           the traffic through the router, every request done and routed
           in two legs, kv_adopted == 8, no re-prefill, revision skew or
           disaggregated fallback, the unified worker idle; launches:
           flash forward == 12 x the prefill worker's full prefills,
           window == 12 x its suffix prefills, paged decode == 12 x the
           decode worker's dispatches, nothing else (the decode worker
           runs no prefill, the prefill worker no decode); the shared
           system prompt's 32 pages exported and fetched once (bytes
           published == unique pages x page bytes + manifests). The same
           traffic straight to the unified worker: the bf16 agreement,
           and the near-tie rule on every request that parts. A planted
           torn page (one byte of a request's last page changed in the
           root) and a planted revision skew (its manifest republished
           naming another revision) each give exactly one counted
           re-prefill of 12 flash or window launches with the output
           unchanged, and adopt once restored. ``run_open_loop`` on a
           unified engine and ``run_open_loop_disagg`` on a pair at 4, 16
           and 40 requests/s (GPT-2's vocabulary, 20 virtual ms a step,
           4 busy ticks a prefill):
           ttft/tpot p50/p95 in virtual ms beside wall seconds, every
           arrival finished, every hand-off adopted, launches exact.
           Then ``neurons.averager.main --strategy genetic`` at the JAX
           defaults over three honest miners (phase 17's): the published
           base == base + sum_i w_i d_i by the plain version on the CPU
           within 1e-6, flash forward == 12 x (the candidate-batches the
           memo's misses evaluated + the merged base's eval batches) and
           nothing else, the population's draws on the card == the CPU's
           bits, and the device ms of a candidate-batch (torch.profiler
           over one cohort). Reports export and adopt ms per request, KV
           bytes per request (fresh, deduped) and the router's added ms.
23. parallel the miner on a dp x fsdp x tp mesh over torch.distributed.
           (a) A world of 1 over NCCL in this process: at the training
           shape (B 8, T 1023, V 50304, E 768), bf16 and f32,
           ``fused_ce_loss_sharded`` on a 1 x 1 x 1 x 1 mesh equals
           ``fused_ce_loss`` bit for bit (loss, count, dh, dW) and
           launches one forward, one dh and one dW; the f32 losses of
           three steps of the mesh engine and a timed bf16 step (B 4, T
           256). The sharded CE's kernels at one rank's shape of world 2
           (N 4092): ms beside the bound, the plain version and the
           library path. (b) A world of 2 over gloo, both ranks on the
           card (NCCL refuses two ranks on one device), in two child
           processes (``--parallel-worker``): the sharded CE on dp2,
           fsdp2, tp2 and tp2 over 1023 rows (one padding row), each
           rank's loss, dh rows and dW shard (summed over dp, as the
           engine sums) held against ``fused_ce_loss`` over every row
           within ``PAR_CE_TOL`` of each output's largest value, which a
           planted halved dW shard and zeroed dh exceed, 1 / 1 / 1
           launches a rank; each collective's
           ms and bytes by backend and route (CUDA tensors staged through
           pinned host memory under gloo); three f32 steps of the fsdp2
           engine within 1e-4 relative of world 1's; a timed bf16 step
           and each rank's peak card memory in it. The same f32 steps
           and timed steps of the tp2 engine, whose blocks split their
           heads and MLP columns (each rank H/tp heads and 4E/tp
           columns): each timed step's collectives exactly those of
           ``_par_tp_step_want`` (tp all-gathers only wte and the c_attn
           leaves, four [rows, E] all-reduces a block), every block
           counted on the head-split route (``sharding.counts``), 12
           launches a step of each flash kernel and one of each CE
           kernel, and a step's device ms by kernel (torch.profiler).
           (c) ``neurons.miner.main`` at world 2 with ``--fsdp 2`` and
           then ``--tp 2`` (``--fused-loss``, B 8, T 128, 3 steps, the
           final push): rc 0 on both ranks, one artifact and its rider on
           the transport, pushes only from rank 0, each rank's launches
           exact (12 x steps of each flash kernel, steps of each CE
           kernel), at ``--tp 2`` every block on the head-split route and
           each step's collectives exact as in (b), its shards after the
           pull bit-equal to the base's slices, the delta finite with a
           held-out score > 0. Any failed rank, collective or check
           fails the phase.
           (d) (b) alone on the meshes of a world of 4 (dp2 x tp2,
           fsdp2 x tp2, fsdp4, tp4 over 1023 rows), four gloo ranks on
           the card: the same summation order of the kernels as over
           NCCL on four cards, with host-memory collectives, so a reading
           that differs between the two points at the NCCL route.
           ``--parallel-cards`` runs (a) and the world of (b) and (c) over
           NCCL with one rank a card on a machine with several cards (at
           world 4 the engines are fsdp4, fsdp2 x tp2 and tp4).
24. mesh roles the validator and the averager on a mesh. Phase 17's
           submissions on a fresh root (three honest MinerLoop miners, a
           stale dense one, phase 16's two hostiles); hard links of it
           give each world and round its own root. (a) A validator round
           (f32, cohort 8) and (b) an averager round with
           ``WeightedAverage`` and one with ``ParameterizedMerge`` (its
           defaults, ``--publish-policy always``; phase 16's chain
           weights), first at world 1 in this process, then at world 2
           over gloo, both ranks on the card, in two child processes
           (``--mesh-roles-worker``) on a dp 2 mesh: the same scores on
           both ranks within 1e-5 relative of world 1's, the hostiles 0
           with the JAX verdicts, one ``set_weights`` (rank 0's), rank 1
           never reading the transport, each rank's flash-forward
           launches exactly 12 x the candidate-batches it evaluated and
           nothing else; the weighted base within 1e-6 of world 1's, the
           parameterized one within 1e-6 of the plain mixture at its
           learned logits (phase 18's limit) and those logits within
           PARAM_LOGITS_LIMIT of world 1's, one publish (rank 0's),
           each rank's launches exact (12 x eval batches of the forward;
           12 x (meta-steps + eval batches) and 12 x meta-steps of each
           backward kernel) and no scatter (a mesh densifies). Each
           round's seconds, peak card memory, and collective calls, bytes
           and ms, a rank. (c) ``neurons.validator.main`` and then
           ``neurons.averager.main`` (its default strategy) as two
           processes joined by ``--multihost-*`` (``--mesh-roles-cli``):
           rc 0 on both, one emission and one publish, rank 0's.
           ``--parallel-cards`` runs the phase's worlds over NCCL, one
           rank a card.
25. sp     sequence parallelism, remat and mu_dtype, GPT-2-124M (bf16
           compute, f32 weights from seed 0). (a) World 1 in this
           process: three f32 steps of the engine on packed batches (B 2
           x T 1024, the flash kernels) and of the ``attention_impl=
           "ring"`` model on their ids alone (no mesh: dense attention),
           and a timed bf16 step at B 4 x T 1024. (b) A world of 2 over
           gloo, both ranks on the card (``--sp-worker``): the ring
           (``ops/ring_attention.py``) on each rank's block of ``[2,
           1024, 12, 64]`` against the dense plain attention of the whole
           sequence, output and gradients (f32 rtol 2e-4 / atol 2e-5,
           JAX's own; bf16 2e-2 of the max); the sp2 engine's three f32
           steps on the packed batches (the gathered route: q, k, v
           all-gathered over sp, the flash kernels on the whole
           sequence) and the ring model's on the ids, each within 1e-4
           relative of world 1's; timed bf16 steps at B 4 x T 1024 of
           sp2 (both routes) and of tp2, each step's launches (12 of
           each flash kernel a step on the gathered route, none on the
           ring; 1 / 1 / 1 CE) and collectives (``_sp_step_want``)
           exact; ``neurons.miner.main`` with ``--sp 2`` (B 8, T 1024,
           3 steps: rc 0, one push from rank 0, the same exact counts,
           the delta finite with a held-out score > 0) and with ``--dp 2
           --dcn-dp 2`` (T 128: its ranks at ``--dp 2``'s coordinates).
           (c) World 1 at the train shape (B 8 x T 1024, packed): f32
           gradients with remat within 1e-6 of the max of those without
           (bit-equality recorded), a bf16 step's peak card memory with
           and without remat (the recomputed forward launches the flash
           forward twice), the optimizer state ``2 x n_params`` bytes
           smaller with every mu leaf bf16 under ``mu_dtype=
           "bfloat16"``, and ``neurons.miner.main`` with ``--remat
           --mu-dtype bfloat16`` (rc 0, one push).
26. llama  the Llama family on the serving path, Llama-3-8B's widths
           (bf16 compute, f32 weights drawn on the card from a seeded
           torch.Generator). (a) The paged decode kernel (8 slots of
           contexts 520-559 over a 64-page table), the window kernel
           (the verify, W 5, and a 64-row suffix over 512) and the flash
           forward (the main path's prefill [1, 1024, 32, 128] with 515
           real rows, [1, 576, 32, 128], a packed [8, 512, 32, 128]) at 32
           query heads over 8 kv heads, D 128, against their plain
           versions: f32 max abs <= 1e-5, bf16 <= 2e-2 (the window also
           within phase 21's per-element limit); each timed in bf16
           (``_time_ms`` and the profiler) beside its bound, the plain
           version and SDPA. (b) At 2 layers in f32: the engine's greedy
           tokens equal ``reference_generate``'s, its pool's head axis is
           8, and a prefill/decode pair equals the unified engine on
           phase 21's traffic (``_disagg_parity``). (c) The whole
           ``llama3-8b`` preset (32 layers, 8,030,261,248 parameters) in
           one engine with the default pool (4,097 pages): phase 21's
           traffic (8 requests sharing a 512-token prompt, 32 new tokens,
           greedy and sampled lanes, prefix cache on) after a warm-up
           request: every request done, prefix hits >= 7, launches exact
           (paged == 32 x decodes, window == 32 x suffix prefills, flash
           == 32 x full prefills, nothing else); ttft, tpot, tokens/s,
           peak memory, and a steady decode step's device ms by kernel and
           idle share (torch.profiler). (d) A GPT-2 drafter with
           GPT-2-124M's widths at the vocabulary 128256 drafts for it: it
           proposes, 0 fallbacks, launches exact for both families (the
           drafter's 12 layers). (e) A prefill and a decode engine on the
           one placed weight set (no tensor copied at install) move the
           pages over a LocalFS transport: kv_adopted 8, no re-prefill,
           each worker's launches exact. (f) In a child process
           (``--llama-cli``; started before phase 22 in the whole script,
           so that its ~400 s of host and disk work overlaps phases 22-25;
           the in-process 8B steps wait for it):
           ``neurons.server.main --model llama3-8b`` with the JAX
           defaults over a LocalFS root whose base the port published:
           the monolithic file (32.12 GB, past the 8 GiB read cap: only
           its hash, the revision, is read), then the shard set and
           manifest on a disk (the temporary directory or the checkout,
           whichever is not tmpfs and has 35 GB free). The machine with
           the card takes at most 45 GiB of live disk data, so the
           monolithic file's directory is a link into /dev/shm. Each
           candidate's free bytes and the host's available memory are
           printed first (``llama_host``), and the step fails when any is
           short. Every request done on that revision, the boot pull
           sharded with no monolithic fallback, launches exact (counted in
           the child); publish, pull and boot seconds. In the whole
           script the child serves the preset cut to 6 layers (9.42 GB of
           f32 weights, still past the read cap); ``--llama`` serves all
           32.
27. llama-train the Llama family on the miner, the validator and the
           averager, at Llama-3-8B's widths. (a) The flash forward and
           backward kernels at the training shape [4, 1024, 32, 128]
           (bf16, a real packed batch's ids) and in f32 at T 256, held as
           phase 4 holds them (the dense plain version, the plain version
           of the kernels' walk, two calls bit-equal); the CE forward and
           backward at N 4096, E 4096, V 128256 (bf16, a real batch's
           targets) and N 256 (f32, against an f64 plain version), held
           as phase 11 holds them (a planted wrong dh or dW must fail the
           limit); each timed in bf16
           (``_time_ms``, the profiler for the forwards and the whole
           backwards) beside its bound, the plain version and the library
           (SDPA with the same mask and causal without ids; cuBLAS GEMM +
           ``F.cross_entropy``); the flash kernels' D 128 registers and
           spills. (b) At 2 layers (1,486,901,248 parameters, remat on, as
           the preset has it), weights drawn on the card from SEED, over
           an in-memory transport: a ``MinerLoop`` with ``--fused-loss``
           and ``--wire-v2`` int8 pulls the base, takes 4 steps at B 4 x T
           1024 and pushes once (losses finite and falling; launches exact:
           flash forward 2 x 2 x steps under remat, the backward pair and
           each CE kernel once a layer and a step); a ``Validator`` round
           at cohort 8 over it, a packed noise submission and a hostile one
           (the miner > 0, the hostile 0 with the JAX verdict, flash
           forward == 2 x eval batches x 3, nothing else); a
           ``WeightedAverage`` round folding both packed submissions
           through the scatter kernel (2 launches) whose published base
           equals base + sum w_i decode(d_i) by the plain versions (1e-6);
           a ``ParameterizedMerge`` round over the same two submissions (2
           meta-steps; the published base against the plain mixture,
           1e-6). (c) At 1 layer in f32: three steps each of the fused
           loss, the unfused loss and the unfused loss with plain
           attention, within 1e-4 relative. (d) The three CLIs on
           ``--model tiny-llama`` with JAX's tests/test_neurons.py argv
           (the preset widened to E 256: its D 16 heads are below the
           flash kernels' D 64): rc 0, one push, the validator's weight >
           0, a new base. (e) tiny-llama at E 256 in f32 on a world of two
           over gloo, both ranks on this card (``--llama-train-worker``):
           fsdp 2, tp 2 (heads split), sp 2 on both routes; losses within
           1e-4 of world 1's, launches and block routes exact. In the whole
           script (b)-(e) run in a child (``--llama-train-child``) started
           before phase 22, (a) after phase 26.
28. lora   LoRA adapters on the miner, the validator and the averager
           (``--lora-rank 8``, alpha 16). (a) At GPT-2-124M full width and
           (b) at ``llama2-7b``'s width cut to 2 layers (weights drawn on
           the card from SEED), one CLI round each on one LocalFS root
           (in /dev/shm when it has room): a LoRA miner with
           ``--fused-loss``, a LoRA miner without it and a full-parameter
           miner with it (4 steps each), then ``validator --lora-rank 8``
           and the default ``averager --lora-rank 8``. The miners' losses
           finite and falling; launches exact (flash forward (2 under
           remat) x layers x steps, the backward pair layers x steps, CE
           forward and dh once a step, and CE dW none on the LoRA miners,
           once a step on the full one); each adapter artifact holds the
           adapters' f32 values and nothing of the base (its bytes
           reported); one LoRA submission densified by the plain path on
           the host (``densify_delta_bytes``) equals the card's
           ``lora_to_full_delta`` within 1e-6; the validator's flash
           forward == layers x 2 eval batches x (3 candidates + base),
           nothing else, its weights on both LoRA miners > 0; the averager
           merges all three (no scatter launch: a LoRA submission is
           densified). In the whole script (a)-(b) run in a child
           (``--lora-child``) after 27b-e's and before 26f's. With
           ``--lora``: (c) the whole ``llama2-7b`` (32 layers,
           6,738,415,616 parameters, remat on, bf16 compute over f32
           weights drawn on the card): first the CE forward and the
           frozen head's dh-only backward at its head's shape (the main
           path's rows, a real batch's targets and mask: N 4092, E 4096,
           V 32000, bf16) against their plain versions
           (``fused_ce_bwd_reference(want_dw=False)``) with
           ``_ce_check``'s limits and planted wrong dh (and the f32
           kernels on 256 rows against an f64 plain version), then timed
           beside the bound, the plain versions and the library's; then
           a ``LoRAEngine`` and ``LoRAMinerLoop`` (``--fused-loss``) over
           an in-memory
           transport take 6 steps at B 4 x T 1024 and push once: losses
           finite and falling, launches exact (CE dW none), step ms,
           tokens/s, the peak of the card's memory, a profiled step; the
           held-out loss of base + adapters (``eval_step``) below the
           base's; the pushed adapter tree (33.6 MB) densified on the
           adapted kernels alone against the card's. (d) Phase 27's
           tiny-llama at E 256 (f32) on a world of two over gloo
           (``--lora-worker``): LoRA miners at dp 2, fsdp 2, sp 2 (the
           gathered route: packed rows) and tp 2, losses
           within 1e-4 of world 1's, the adapters the same on both ranks,
           launches and block routes exact, one push.
29. convert ``--init-from`` and ``--scan-blocks``. A GPT-2-124M
           checkpoint of seeded random weights is written as HF lays it
           out (one f32 ``model.safetensors``, no ``lm_head.weight``) in
           a local HF cache (``models--openai-community--gpt2/snapshots/
           <commit>/``, ``refs/main``), ``HF_HUB_CACHE`` pointed at it;
           then the miner (``--fused-loss``, 8 steps), the validator,
           the averager (``--strategy weighted``) and the server CLIs run
           with ``--init-from hf:openai-community/gpt2`` and nothing
           published: each exits 0, its first params bit-equal to the
           checkpoint's (the padded vocabulary rows zero), launches
           exact; the miner's push is finite and the validator weighs it
           above 0; the server finishes phase 21's 8 requests. A
           ``--scan-blocks`` miner takes the same steps on the same data:
           its losses and pushed bytes must equal the unrolled miner's
           and its state must hold ``h.block.*`` leaves with a leading
           12; each step's ms is recorded for both. Before these, and
           after them, two miner CLIs on local text (8 ``--fused-loss``
           steps, B 4 x T 512): first run A, in the phase's process
           before it loads a kernel, with
           ``--tokenizer bpe --dataset files:<repo>/docs/**/*.md
           --compile-cache-dir <fresh dir>`` (the BPE trained first on
           the same files and saved in its work dir; ``--tokenizer word``
           where ``tokenizers`` cannot be imported), and at the phase's
           end, once its runs have freed the card's memory, run B, as a
           restart (the loaded kernels and packer forgotten), with the
           same ``--compile-cache-dir`` and neither ``--tokenizer`` nor
           ``--dataset``: each exits 0 with finite, falling losses
           and exact launches; A's ids below the BPE's vocabulary, its
           kernels and packer built into the fresh directory (seconds
           recorded); B builds nothing (every build 0.0 s, no compiler
           run), and the tokenizer and corpus ``auto`` resolved to are
           recorded. Then, on the host, the C++ packer's rows against the
           Python loop's on A's corpus and ids, every field, and each
           one's rows/s. In the whole script it runs in a child
           (``--convert-child OUT``) started beside the llama chain.
           With ``--convert``: a bf16 ``llama2-7b`` checkpoint of seeded
           random weights (drawn on the card) in two shards as HF names
           them (13.5 GB, on a disk with 20 GB free),
           each tensor fingerprinted on the card; then, in a fresh process
           (``--convert-miner``), the LoRA miner CLI (``--model
           llama2-7b --lora-rank 8 --init-from DIR --fused-loss``, 6
           steps at B 4 x T 1024, nothing published): the f32 base on the
           card after the bootstrap exact in bf16 and fingerprinted equal
           to the checkpoint, losses finite and falling, launches exact
           (CE dW 0), every flash and CE launch synchronised and checked
           (``--lora-soak --checked``'s wrappers), the conversion's
           seconds, the process's peak RSS and read counters recorded;
           the checkpoint is deleted before the phase ends.
30. health The fleet health plane at GPT-2-124M (full width and depth),
           ``--heartbeat-interval 0.5`` on every role, each role CLI a
           process of its own (``--health-role``), at most three at once.
           (a) One card, one LocalFS root with the genesis base and a
           metagraph of two miners and a validator: a miner's beat timed
           (the vitals' host ms and the upload, its bytes); two miners
           of 30 ``--fused-loss --wire-v2`` steps alone, without and with
           beats (step p50 of each; hotkey_2, the one with beats, stops
           after its first push; the one without runs under ``--health``
           alone: ``--beat-ab`` makes the comparison in full); a
           ``--remediate`` primary averager
           (``--strategy weighted``, lease epoch 1 acquired at boot) and
           a live miner (hotkey_1, pulling every 2 s, pushing every 4 s,
           a step every 0.25 s at most);
           a ``--remediate`` validator's 7 rounds, whose JSONL must hold
           hotkey_2's ``stale_node`` breach at round 5, its quarantine,
           its score 0 in the ledger and the round scores after, and the
           effective cohort 2 then 1; a ``--standby`` that follows the
           beating primary 6 s (past its 4 s deadline), then, once the
           primary stops between two rounds, takes epoch 2 within the
           deadline plus a poll and a beat of the primary's last signal,
           bootstraps and publishes; every published base one holder
           (epoch 1 the primary's, 2 the standby's, none twice). Launches
           exact from each process's own counts: miners per step, the
           validator per candidate-batch, each averager per merge (the
           flash forward of its eval, one scatter a packed contribution).
           (b) On a world of two over gloo (both ranks on this card, as
           phase 24): a ``--remediate`` primary (acquire and stamp once,
           by the coordinator), a ``--standby`` behind it (both ranks
           take over at epoch 2 and exit 0), and ``--hier sub
           --remediate`` whose ``__agg__.n0`` artifact's bytes equal a
           one-process node's on a copy of the root (two dense deltas
           and an int8 wire-v2 one, folded packed: one scatter launch in
           the process and on each rank). Every role's CLI returns 0.
           ``--beat-ab`` times the miner's step without and with beats,
           alternating (:func:`beat_ab`). In the whole script
           it runs in the child of phase 29, after it (``--health-child
           OUT``); ``--health`` runs it alone after the build.
31. obs    the device observatory, the exporter and fault injection, at
           GPT-2-124M (B 4 x T 512). First the kernels the phase runs
           against their plain versions at its shapes: flash forward and
           backward at [4, 512, 12, 64] (a real packed batch's ids, as
           phase 4 holds them), the fused CE at its 2044 rows (the
           batch's targets and mask, as phase 11), paged decode at the
           server's 8 slots (contexts 515-664) and the window at a
           64-row suffix over 512 (as phase 21). (a) The miner CLI
           (``--fused-loss --wire-v2 --metrics-path ... --obs-port P
           --heartbeat-interval 0.5``) in a process of its own: once it
           has taken 10 steps, /metrics (timed; ``dt_prog_*`` of
           ``train.step`` present), /healthz and /debug/stacks are
           read, ``/debug/profile?ms=300`` captures while a second
           capture must answer 409, and the trace must name
           ``dt.train.step[4x512]`` and the flash and CE kernels; the
           miner is stopped, and its JSONL's last ``{"devprof"}`` record
           must give train.step FLOPs within 5% of the analytic count
           (the matrix products, the flash kernels' 18 D FLOPs a visible
           pair and head for the first batch, the CE's 8 N V E) and an
           ``achieved_flops_frac`` in (0, 1.05] against the card's
           roofline; its last beat must carry ``anat.step_ms``,
           ``anat.device_ms`` and ``anat.host_ms``; launches exact (12 x
           steps of each flash kernel, steps of each CE kernel). (b) The
           server CLI in this process with ``--obs-port`` and
           ``--metrics-path``: phase 21's prompts as 8 greedy requests,
           /metrics scraped while it serves must hold
           ``dt_serve_ttft_ms{q="0.5"}`` and ``dt_prog_exec_ms{prog=
           "serve.decode",...}``; launches exact (paged decode 12 x
           decode dispatches, window 12 x suffix prefills, flash forward
           12 x full prefills); serve.decode's devprof record. (c) Two
           miner CLIs (dense pushes, 3 steps) and then a validator round
           (one ingest worker), each a process with ``--chaos-spec``
           (seed 3, ``fetch_error_rate`` 0.2, hotkey_2 partitioned):
           every process exits 0, and the verdicts, the miners scored
           above 0 and every process's ``chaos.*`` counters equal
           OBS_CHAOS_ROUND, what tests/test_torch_chaos.py pins for the
           same spec on the CPU. (d) A back-to-back pair of 30-step
           miners with ``--metrics-path``, without and with
           ``--no-devprof``: each one's step p50 and first step's host
           wall (``--obs`` alone: ``--devprof-ab`` makes the comparison
           in full). In the whole script it runs, without (d), in the
           child of phases 29 and 30, after them (``--obs-child OUT``);
           ``--obs`` runs it alone after the build.

Output: a ``kernels`` JSON line, a ``slice`` JSON line, a ``train`` JSON
line, a ``miner`` JSON line, an ``averager`` JSON line, a ``validator``
JSON line (phases 17 and 18), a ``defaults`` JSON line (phase 19), a
``slice5`` JSON line (phase 20), a ``serve6`` JSON line (phase 21), a
``serve6b`` JSON line (phase 22), a ``parallel`` JSON line (phase 23),
a ``mesh_roles`` JSON line (phase 24), an ``sp`` JSON line (phase 25),
an ``llama`` JSON line (phase 26; its ``llama_host`` line comes first),
an ``llama_train`` JSON line (phase 27), a ``lora`` JSON line (phase
28), a ``convert`` JSON line (phase 29), a ``health`` JSON line (phase
30), an ``obs`` JSON line (phase 31), the ``nvidia-smi``
name/power-limit line,
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
import shutil
import statistics
import subprocess
import sys
import time
import traceback
import urllib.error
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
        "count": torch.cuda.device_count(),
        "text_libs": _text_libs()}}), flush=True)
    return card


def _text_libs() -> dict:
    """What the local-text path can use on this machine: the HF libraries
    (importable or not; nothing is installed or fetched) and ``g++``."""
    import importlib.util
    out = {m: importlib.util.find_spec(m) is not None
           for m in ("tokenizers", "transformers", "datasets")}
    out["g++"] = shutil.which("g++")
    return out


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
    """One nvcc per source under csrc/, and the host packer
    (``native/packing.cpp``), all started together."""
    from distributedtraining_tpu_torch import native
    from distributedtraining_tpu_torch.ops import _cuda
    names = _cuda.sources()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as ex:
        packer = ex.submit(native.build, "packing")
        secs = dict(zip(names, ex.map(_cuda.build, names)))
        packer_s = packer.result()
    build_s = time.perf_counter() - t0
    out = {"build_s": build_s, "sources": {},
           "packer": {"s": packer_s, "compiler": native.compiler()[0]}}
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
    dev = DEV
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


FLASH_TOLS = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}


def _flash_check(name: str, q, k, v, do, st) -> dict:
    """The flash forward and backward kernels on one case against their
    plain versions: the dense plain forward and backward on the same
    values in f32, the plain version of the kernels' walk in their dtype
    (bf16: P and dS rounded before their products), and a second call
    of each backward kernel, which must give the same bits (no atomics).
    f32 is held to ``FLASH_TOLS``' absolute limits, bf16 to the error
    over max(1, |value|)."""
    import torch
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    o, lse = fa.flash_attention_fwd(q, k, v, st)
    di = fa._row_dot(o, do)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, st)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, di, st)
    f = [x.float() for x in (q, k, v)]
    ref_o, ref_lse = fa.flash_attention_reference(*f, st)
    ref_g = fa.flash_attention_bwd_reference(
        *f, o.float(), lse, do.float(), st)
    ref_t = fa.flash_attention_bwd_tiled_reference(q, k, v, o, lse, do, st)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, st)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, di, st)
    torch.cuda.synchronize()
    pairs = {"o": (o, ref_o), "lse": (lse, ref_lse),
             "dq": (dq, ref_g[0]), "dk": (dk, ref_g[1]),
             "dv": (dv, ref_g[2]), "dq_tiled": (dq, ref_t[0]),
             "dk_tiled": (dk, ref_t[1]), "dv_tiled": (dv, ref_t[2])}
    dt = str(q.dtype).split(".")[1]
    tol_f, tol_b = FLASH_TOLS[dt]
    changed = _differs_bitwise({"dq": dq, "dk": dk, "dv": dv},
                               {"dq": dq2, "dk": dk2, "dv": dv2})
    check(not changed, f"flash backward at {name} {dt}: a second "
                       f"call on the same inputs changed {changed}")
    c = {"case": name, "dtype": dt,
         "max_abs": {key: _max_err(a, r) for key, (a, r) in pairs.items()},
         "tol_fwd": tol_f, "tol_bwd": tol_b, "bitwise_repeatable": True}
    # the limits apply to the abs error in f32, to the scaled one in bf16
    if dt == "bfloat16":
        c["max_scaled"] = {key: _max_err(a, r, scaled=True)
                           for key, (a, r) in pairs.items()}
    for key, err in c.get("max_scaled", c["max_abs"]).items():
        tol = tol_f if key in ("o", "lse") else tol_b
        check(err <= tol, f"flash kernel vs plain version at {name} "
                          f"{dt}: {key} max abs {err} > {tol}")
    check(all(bool(torch.isfinite(x).all()) for x in (o, lse, dq, dk, dv)),
          f"flash kernels: non-finite output at {name} {dt}")
    return c


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
        # a tp rank's heads (phase 23): views of its [B, T, 3E/tp] local
        # projection, token stride 1152 at tp 2 (the --tp 2 CLI's B 8,
        # T 128) and 576 at tp 4 (the engine's B 4, T 256)
        "tp2_heads_b8_t128_h6": (8, 128, 6, 64, seg),
        "tp4_heads_b4_t256_h3": (4, 256, 3, 64, seg),
    }
    checks = []
    for i, (name, (B, T, H, D, sg)) in enumerate(cases.items()):
        for dt in FLASH_TOLS:
            checks.append(_flash_check(name, *_flash_case(
                B, T, H, D, sg, getattr(torch, dt), SEED + i)))

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


def _post(port: int, body: dict, timeout: float = 300.0,
          path: str = "/generate"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
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
    from distributedtraining_tpu_torch.engine.serve import GenerationEngine
    from distributedtraining_tpu_torch.models import gpt2
    cfg = gpt2.PRESETS["gpt2-124m"]
    model, _ = gpt2.make_model(cfg)
    state = gpt2.params_from_numpy(tree, device="cuda")
    prompts = _prompts((8, 40, 100, 200, 350, 500, 700, 900),
                       cfg.vocab_size, SEED + 2)
    eng = GenerationEngine(model, state, device="cuda", max_slots=8,
                           page_size=16)
    try:
        for p in prompts:
            eng.submit(p, 32)
        for _ in range(4):                 # admit + prefill all, warm up
            eng.step()
        check(eng.active_count == len(prompts), "profile batch not full")
        res = _profile_steps(eng, 8, "paged_decode")
    finally:
        eng.close()
    busy = res["device_ms_per_step"]
    res.update(batch=len(prompts), paged_decode_share=(
        res["paged_decode_ms_per_step"] / busy if busy else None))
    log("profile:", json.dumps(res))
    log(f"decode step: {res['device_ms_per_step']} device ms, the paged "
        f"kernel {res['paged_decode_ms_per_step']} ms "
        f"({res['paged_decode_share']} of it)")
    return res


def _profile_steps(eng, n_steps: int, marker: str) -> dict:
    """torch.profiler over ``n_steps`` steady steps of ``eng`` (its slots
    already full): wall and device ms a step, the idle share, launches a
    step, the device ms of the kernels whose name holds ``marker``, and
    the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            k = kernels.setdefault(evt.name, [0.0, 0])
            k[0] += evt.time_range.elapsed_us() / 1e3
            k[1] += 1
    busy_ms = sum(v[0] for v in kernels.values())
    mine = sum(v[0] for n, v in kernels.items() if marker in n)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"steps": n_steps, "wall_ms_per_step": wall_ms / n_steps,
            "device_ms_per_step": busy_ms / n_steps,
            "idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
            "kernels_per_step": sum(v[1] for v in kernels.values())
            / n_steps,
            f"{marker}_ms_per_step": mine / n_steps,
            "top_kernels": [{"name": n[:80], "ms_per_step": v[0] / n_steps,
                             "launches_per_step": v[1] / n_steps}
                            for n, v in top]}


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
# phase 24: the largest distance of a rank's learned logits (Adam, 8
# meta-steps at lr 0.01 from 0) from world 1's. Sound runs read 2.01e-4
# (bf16 partial sums in another order); the logits' gradient doubled on
# every rank reads 3.09e-3, its all-reduce dropped 0.160 (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md, phase 24's limit)
PARAM_LOGITS_LIMIT = 1e-3
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


# ---------------------------------------------------------------------------
# 21. serve6: the server role (window kernel, sampler, prefix cache,
# speculation, the watcher's swap) through its CLI
# ---------------------------------------------------------------------------

def _window_case(B, W, lens, dtype, seed, Hq=12, Hkv=12, D=64, P=16,
                 MP=64):
    """Random q/pool/window rows; each lane's table names distinct pages
    for its used entries and trash page 0 (poisoned) for the rest."""
    import torch
    g = torch.Generator().manual_seed(seed)
    pool = 1 + B * MP
    q = torch.randn((B, W, Hq, D), generator=g)
    kp = torch.randn((pool, P, Hkv, D), generator=g)
    vp = torch.randn((pool, P, Hkv, D), generator=g)
    kp[0] = 1e3
    vp[0] = 1e3
    kn = torch.randn((B, W, Hkv, D), generator=g)
    vn = torch.randn((B, W, Hkv, D), generator=g)
    tables = torch.zeros((B, MP), dtype=torch.int32)
    perm = torch.randperm(pool - 1, generator=g) + 1
    for b, n in enumerate(lens):
        used = (n + P - 1) // P
        tables[b, :used] = perm[b * MP:b * MP + used].to(torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32)
    return (q.to(DEV, dtype), kp.to(DEV, dtype), vp.to(DEV, dtype),
            tables.to(DEV), sl.to(DEV), kn.to(DEV, dtype),
            vn.to(DEV, dtype))


def _window_bound(args, elt: int) -> tuple[float, str]:
    """Least time for the window on these inputs: the K/V rows the
    seq_lens reach, q, the window's k/v, the output and the tables once
    over the memory rate, against QK and PV (2 flops a multiply-add) of
    every visible pair over the bf16 tensor-core rate."""
    q, kp, _, tables, sl, _, _ = args
    B, W, Hq, D = q.shape
    _, P, Hkv, _ = kp.shape
    MP = tables.shape[1]
    ctx = [min(int(n), MP * P) for n in sl.tolist()]
    nbytes = (sum(ctx) * Hkv * D * 2 * elt + B * W * (2 * Hq + 2 * Hkv)
              * D * elt + tables.numel() * 4 + B * 4)
    pairs = sum(W * c + W * (W + 1) // 2 for c in ctx)
    flops = 4 * pairs * Hq * D
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = flops / H100_BF16_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def _window_library(args):
    """SDPA on the pre-gathered context plus the window's rows, with the
    window's mask (context below seq_len, fresh rows causal). A yardstick
    only; the port never calls it."""
    import torch
    q, kp, vp, tables, sl, kn, vn = args
    B, W, Hq, D = q.shape
    _, P, Hkv, _ = kp.shape
    MP = tables.shape[1]
    idx = tables.long()
    k = torch.cat([kp[idx].reshape(B, MP * P, Hkv, D), kn], 1)
    v = torch.cat([vp[idx].reshape(B, MP * P, Hkv, D), vn], 1)
    k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    pos = torch.arange(MP * P + W, device=q.device)
    t = torch.arange(W, device=q.device)
    mask = ((pos[None, None, :] < sl[:, None, None])
            | ((pos[None, None, :] >= MP * P)
               & (pos[None, None, :] - MP * P <= t[None, :, None])))
    mask = mask[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, k, v, attn_mask=mask, enable_gqa=Hq != Hkv)


SERVE_LENS = [8, 40, 100, 200, 350, 500, 700, 900]


WINDOW_BF16_REL = 2.0 ** -7     # one bf16 ulp of the value
WINDOW_BF16_ABS = 1e-4          # times the case's max |plain|


def _window_bf16_ratio(out, ref32) -> float:
    """How far a bf16 window output is from the plain version computed in
    f32 on the same (bf16-valued) inputs, as a share of the limit
    ``2^-7 |plain| + 1e-4 max|plain|`` per element: the kernel keeps
    f32 through the softmax and rounds once at the store (half an ulp),
    so a right kernel reads <= 0.5; a dropped 32-row tile moves outputs
    of ~0.05 by ~1e-2, far past it."""
    ref = ref32.float()
    lim = ref.abs() * WINDOW_BF16_REL + WINDOW_BF16_ABS * float(
        ref.abs().max())
    return float(((out.float() - ref).abs() / lim).max())


def _smi_clocks() -> str | None:
    """The card's SM clock, memory clock and power draw now, as
    ``nvidia-smi`` reads them (None if it cannot)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else None


def _device_ms(fn, reps: int = 20) -> float | None:
    """Device time of one call by the profiler: the sum of the kernels it
    enqueues (the L2 evicted before each, as ``_time_ms`` does), averaged
    over ``reps`` calls. Unlike ``_time_ms`` it leaves out the host's
    share of a call that takes longer to enqueue than the eviction keeps
    the device busy. None unless every kernel was seen a multiple of
    ``reps`` times and the eviction exactly ``reps`` times: a long process
    can lose profiler events (seen after ~18 sessions), and a partial
    record would read short."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if e.device_time_total > 0]
    evict = [e for e in evts if "FillFunctor<unsigned char>" in e.key]
    kernels = [e for e in evts if e not in evict]
    if ([e.count for e in evict] != [reps] or not kernels
            or any(e.count % reps for e in kernels)):
        return None
    return sum(e.device_time_total for e in kernels) / reps / 1e3


# the window's timed shapes: the verify, a 512-row suffix over 900
# positions, and phase 21's own suffix prefills (64 rows over the 512-token
# system prompt)
WINDOW_TIMED = {"verify_w5": dict(B=8, W=5, lens=SERVE_LENS),
                "suffix_w512_ctx900": dict(B=1, W=512, lens=[900]),
                "suffix_w64_ctx512": dict(B=1, W=64, lens=[512])}


def _window_timings() -> dict:
    """The window call at ``WINDOW_TIMED`` in bf16, through the public
    wrapper only: ``_time_ms`` (ms), the profiler's device time
    (device_ms), host ms, the plain version, SDPA on the pre-gathered
    context (library_ms, library_device_ms) and the bound."""
    import torch
    from distributedtraining_tpu_torch.ops import paged_attention as pa
    timed = {}
    for name, c in WINDOW_TIMED.items():
        args = _window_case(c["B"], c["W"], c["lens"], torch.bfloat16, SEED)
        bound_ms, bound_by = _window_bound(args, 2)
        lib = _window_library(args)
        timed[name] = {
            "ms": _time_ms(lambda: pa.paged_window_attention(*args)),
            "device_ms": _device_ms(lambda: pa.paged_window_attention(*args)),
            "host_ms": _host_ms(lambda: pa.paged_window_attention(*args)),
            "plain_ms": _time_ms(lambda: pa.paged_decode_reference(*args)),
            "library_ms": _time_ms(lib), "library_device_ms": _device_ms(lib),
            "bound_ms": bound_ms, "bound_by": bound_by}
    return timed


def phase_window() -> dict:
    """The window kernel against its plain version and against the plain
    version of its decomposition (``paged_window_split_reference``) at
    the verify's shape (W 5, 8 slots, contexts 8-900; and with padded
    lanes), one query a slot (W 1, the decode witness's shape), the
    suffix prefill's (one slot, W 16, 64, 512 over contexts 0, P - 1, P,
    P + 1, 900; W 64 over 512, phase 21's own) and a GQA case; timed at
    ``WINDOW_TIMED`` (bf16). f32 is held to 1e-5 absolute against both;
    bf16 per element against the plain version in f32 on the same inputs
    and against the decomposition's bf16 output (``_window_bf16_ratio``
    <= 1 each), and the same limit must reject the plain version with
    the last 32 context rows of every lane dropped (a planted lost tile)
    wherever a lane has 64 or more. Every reading is logged before the
    first check."""
    import torch
    from distributedtraining_tpu_torch.ops import paged_attention as pa
    tols = {torch.float32: 1e-5,
            torch.bfloat16: f"{WINDOW_BF16_REL} |plain| + "
                            f"{WINDOW_BF16_ABS} max|plain| (plain in f32)"}
    cases = {"verify_w5": dict(B=8, W=5, lens=SERVE_LENS),
             "verify_w5_padded": dict(B=8, W=5, lens=SERVE_LENS[:6]
                                      + [0, 0]),
             "decode_w1": dict(B=8, W=1, lens=SERVE_LENS)}
    for W in (16, 64, 512):
        for n in (0, 15, 16, 17, 900):
            cases[f"suffix_w{W}_ctx{n}"] = dict(B=1, W=W, lens=[n])
    cases["suffix_w64_ctx512"] = dict(B=1, W=64, lens=[512])
    cases["gqa_w33_d128"] = dict(B=2, W=33, lens=[17, 200], Hq=32, Hkv=8,
                                 D=128, MP=16)
    checks = []
    for i, (name, c) in enumerate(cases.items()):
        for dtype, tol in tols.items():
            kw = {k: v for k, v in c.items() if k not in ("B", "W", "lens")}
            args = _window_case(c["B"], c["W"], c["lens"], dtype, SEED + i,
                                **kw)
            out = pa.paged_window_attention(*args)
            f32 = [a.float() if a.is_floating_point() else a for a in args]
            ref = pa.paged_decode_reference(*f32)
            split = pa.paged_window_split_reference(*args)
            torch.cuda.synchronize()
            row = {"shape": name, "dtype": str(dtype).split(".")[1],
                   "finite": bool(torch.isfinite(out).all()),
                   "max_abs_err": float((out.float() - ref).abs().max()),
                   "max_abs_err_split": float(
                       (out.float() - split.float()).abs().max()),
                   "tol": tol}
            if dtype == torch.bfloat16:
                row["limit_ratio"] = _window_bf16_ratio(out, ref)
                row["limit_ratio_split"] = _window_bf16_ratio(out, split)
                if max(c["lens"]) >= 64:
                    short = torch.clamp(f32[4] - 32, min=0)
                    lost = pa.paged_decode_reference(*f32[:4], short,
                                                     *f32[5:])
                    row["planted_lost_tile_ratio"] = _window_bf16_ratio(
                        lost, ref)
            checks.append(row)
    log("window checks:", json.dumps(checks))
    for row in checks:
        at = f"{row['shape']} {row['dtype']}"
        check(row["finite"], f"window kernel: non-finite output at {at}")
        if row["dtype"] == "float32":
            for key in ("max_abs_err", "max_abs_err_split"):
                check(row[key] <= row["tol"], f"window kernel at {at}: "
                      f"{key} {row[key]} > {row['tol']}")
        else:
            for key in ("limit_ratio", "limit_ratio_split"):
                check(row[key] <= 1.0, f"window kernel at {at}: {key} "
                      f"{row[key]} of the limit")
            check(row.get("planted_lost_tile_ratio", 2.0) > 1.0,
                  f"window bf16 limit passes a lost tile at {at}")
    res = {"checks": checks, "timed": _window_timings(),
           "clocks": _smi_clocks(), "timed_dtype": "bfloat16"}
    log("window phase:", json.dumps(res))
    return res


def phase_sampler() -> dict:
    """The sampler on the card against the sampler on the CPU: the
    threefry bits of 64 keys over GPT-2's vocabulary are equal; the picks
    on logits without near-ties are equal; on random normal logits the
    share of equal picks is reported (a Gumbel draw is within an ulp of
    log, and an ulp can swap two near-equal ranks)."""
    import torch
    from distributedtraining_tpu_torch.engine import serve
    from distributedtraining_tpu_torch.utils import prng
    V, B = 50257, 64
    g = torch.Generator().manual_seed(SEED)
    seeds = torch.randint(0, 2**31 - 1, (B,), generator=g)
    idx = torch.randint(0, 10**6, (B,), generator=g)
    keys = prng.fold_in(prng.prng_key(seeds), idx)
    bits_cpu = prng.random_bits(keys, V)
    bits_gpu = prng.random_bits(keys.to(DEV), V).cpu()
    check(bool((bits_cpu == bits_gpu).all()),
          "sampler: threefry bits differ between the card and the CPU")
    temps = torch.tensor([0.0, 0.7, 1.0, 1.6] * (B // 4))
    top_ps = torch.tensor([1.0, 0.9, 0.95, 0.5] * (B // 4))
    spread = torch.stack([torch.randperm(V, generator=g) for _ in range(B)]
                         ).float() * 0.05

    def both(logits):
        cpu = serve._sample_from_logits(logits, temps, top_ps, seeds, idx)
        gpu = serve._sample_from_logits(logits.to(DEV), temps.to(DEV),
                                        top_ps.to(DEV), seeds.to(DEV),
                                        idx.to(DEV)).cpu()
        return cpu, gpu

    cpu, gpu = both(spread)
    check(bool((cpu == gpu).all()),
          f"sampler: picks differ on logits without near-ties "
          f"({int((cpu != gpu).sum())} of {B})")
    cpu, gpu = both(torch.randn((B, V), generator=g) * 2.0)
    res = {"keys": B, "vocab": V, "bits_equal": True,
           "no_tie_picks_equal": True,
           "random_logits_agreement": float((cpu == gpu).float().mean())}
    log("sampler phase:", json.dumps(res))
    return res


def _record_sampled_rows(store: list):
    """Patch ``serve._pick`` (the target's picks) and the drafter's
    ``speculative._pick`` so each keeps the sampled rows it sees: the f32
    logits, the lane's temperature, top_p and key, and the pick, tagged
    with the verify round (target rows only inside ``_verify``; the
    drafter's catch-up steps, whose picks are dropped, are skipped) and
    their order within the round among the lane's rows: the drafter's
    step s and the verify's window row s read the same tokens, so they
    pair by that order and not by the keys under test. Returns the
    undo."""
    import numpy as np
    from distributedtraining_tpu_torch.engine import serve
    from distributedtraining_tpu_torch.engine import speculative as spec
    real_pick, real_verify = serve._pick, serve.GenerationEngine._verify
    state = {"round": 0, "in_verify": False}
    nth: dict = {}

    def recorder(side):
        def pick(logits, temps, top_ps, seeds, tok_idx):
            out = real_pick(logits, temps, top_ps, seeds, tok_idx)
            if side == "draft" or state["in_verify"]:
                for r in np.flatnonzero(np.asarray(temps) > 0):
                    if side == "draft" and int(tok_idx[r]) == 0:
                        continue
                    lane = (side, state["round"], int(seeds[r]))
                    nth[lane] = nth.get(lane, -1) + 1
                    store.append({
                        "side": side, "round": state["round"],
                        "key": (int(seeds[r]), nth[lane]),
                        "seed": int(seeds[r]), "tok_idx": int(tok_idx[r]),
                        "row": logits[int(r)].float().clone(),
                        "temp": float(temps[r]), "top_p": float(top_ps[r]),
                        "pick": int(out[r])})
            return out
        return pick

    def verify(eng, active, plan):
        state["in_verify"] = True
        try:
            return real_verify(eng, active, plan)
        finally:
            state["in_verify"] = False
            state["round"] += 1

    serve._pick, spec._pick = recorder("verify"), recorder("draft")
    serve.GenerationEngine._verify = verify

    def undo():
        serve._pick = spec._pick = real_pick
        serve.GenerationEngine._verify = real_verify
    return undo


def _ranked(row, temp: float, top_p: float):
    """The sampler's view of one row (``serve._sample_from_logits``): the
    scaled logits, their stable descending order and how many ranks
    top_p keeps."""
    import torch
    scaled = row / max(temp, 1e-6)
    order = torch.argsort(-scaled, stable=True)
    ranked = scaled[order]
    e = torch.exp(ranked - ranked.max())
    probs = e / e.sum()
    kept = int(((torch.cumsum(probs, -1) - probs) < top_p).sum())
    return scaled, order, kept


def _sampled_pair_readings(store: list) -> dict:
    """Each sampled proposal beside the target's verify row at the same
    place in the same round (the same tokens before it; each side's own
    key): the drafter's row came from the decode kernel, the verify's
    from the window kernel. For the pairs whose picks differ: whether
    the two rows rank the kept tokens in the same order (then only the
    key or the sampler could make them differ: counted as faults),
    whether the two picks sit at the same rank (the rows swapped which
    token holds the winning rank's Gumbel draw), and the logit gap
    between the verify's winner and its rank neighbours against the
    rows' max |logit difference|. Two witnesses: the drafter's rows
    picked again under the verify's lane parameters and keys (one set of
    logits through both sides' sampling: the share that gives back the
    proposal), and the verify's rows with random noise, once of ~1 f32
    ulp relative and once Gaussian at each pair's RMS |logit difference|
    (the share of picks noise of each size moves: the second should
    come near the pairs' own share if the rows' difference alone parts
    them)."""
    import numpy as np
    import torch
    from distributedtraining_tpu_torch.engine import serve
    draft = {(e["round"], e["key"]): e for e in store if e["side"] == "draft"}
    pairs = [(draft[(e["round"], e["key"])], e) for e in store
             if e["side"] == "verify" and (e["round"], e["key"]) in draft]
    dlog, dlog_differ, gaps, gaps_differ, kept = [], [], [], [], []
    differ = same_order = same_rank = within = 0
    for d, v in pairs:
        sd, od, kd = _ranked(d["row"], d["temp"], d["top_p"])
        sv, ov, kv = _ranked(v["row"], v["temp"], v["top_p"])
        delta = float((d["row"] - v["row"]).abs().max())
        rv = int((ov == v["pick"]).nonzero()[0, 0])
        rd = int((od == d["pick"]).nonzero()[0, 0])
        ranked = sv[ov]
        near = [float(ranked[rv - 1] - ranked[rv])] if rv > 0 else []
        if rv + 1 < ranked.numel():
            near.append(float(ranked[rv] - ranked[rv + 1]))
        gap = min(near) * v["temp"]          # in logit units
        dlog.append(delta)
        gaps.append(gap)
        kept.append(kv)
        if d["pick"] == v["pick"]:
            continue
        differ += 1
        dlog_differ.append(delta)
        gaps_differ.append(gap)
        k = max(kd, kv)
        same_order += int(kd == kv and bool((od[:k] == ov[:k]).all()))
        same_rank += int(rd == rv)
        within += int(gap <= 2 * delta)
    same_logits = ulp_flips = rms_flips = rms_p50 = abs_p50 = None
    if pairs:
        lanes = [np.asarray([v[k] for _, v in pairs])
                 for k in ("temp", "top_p", "seed", "tok_idx")]
        again = serve._pick(torch.stack([d["row"] for d, _ in pairs]),
                            *lanes)
        same_logits = sum(a == d["pick"] for a, (d, _) in
                          zip(again, pairs)) / len(pairs)
        rows = torch.stack([v["row"] for _, v in pairs])
        g = torch.Generator(device=rows.device).manual_seed(SEED)
        noise = (torch.rand(rows.shape, generator=g, device=rows.device)
                 * 2 - 1) * 2.0 ** -23
        moved = serve._pick(rows * (1 + noise), *lanes)
        ulp_flips = sum(a != v["pick"] for a, (_, v) in
                        zip(moved, pairs)) / len(pairs)
        rms = torch.stack([(d["row"] - v["row"]).pow(2).mean().sqrt()
                           for d, v in pairs])
        moved = serve._pick(rows + torch.randn(
            rows.shape, generator=g, device=rows.device) * rms[:, None],
            *lanes)
        rms_flips = sum(a != v["pick"] for a, (_, v) in
                        zip(moved, pairs)) / len(pairs)
        rms_p50 = float(rms.median())
        abs_p50 = float(rows.abs().amax(dim=1).median())
    med = lambda xs: statistics.median(xs) if xs else None  # noqa: E731
    return {"pairs": len(pairs), "picks_differ": differ,
            "witness_draft_rows_verify_keys_agree": same_logits,
            "witness_ulp_noise_flip_rate": ulp_flips,
            "witness_rms_dlogit_noise_flip_rate": rms_flips,
            "rms_dlogit_p50": rms_p50, "row_max_abs_logit_p50": abs_p50,
            "differ_same_order": same_order,
            "differ_same_rank": same_rank,
            "differ_winner_gap_within_2_max_dlogit": within,
            "max_dlogit_p50": med(dlog), "max_dlogit_max": max(dlog,
                                                                 default=None),
            "max_dlogit_p50_differ": med(dlog_differ),
            "winner_gap_p50": med(gaps), "winner_gap_p50_differ":
                med(gaps_differ),
            "kept_ranks_p50": med(kept)}


def _decode_through_window():
    """A witness, not the port's path: the model's paged attention with
    one query a slot goes through the window kernel too (W = 1), so a
    plain decode and a verify's first row share one attention kernel.
    Returns the undo."""
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.ops import paged_attention as pa
    real = gpt2.paged_attention

    def route(q, *a):
        return pa.paged_window_attention(q, *a) if q.is_cuda else real(q, *a)
    gpt2.paged_attention = route
    return lambda: setattr(gpt2, "paged_attention", real)


def _spec_parity_f32(tree, prompts) -> dict:
    """Spec-on (self-draft, K 4) against spec-off at f32 compute, and a
    scripted drafter that is always wrong: greedy lanes must be token
    identical, the self-draft must have proposed with no fallback to
    plain decode. Sampled lanes are reported, with the readings that say
    why they part (``_sampled_pair_readings``; a differing pair whose
    rows rank the kept tokens alike fails the phase) and a witness: the
    spec-off run again with its decode through the window kernel,
    against the zero-accept run, whose every token is a verify's first
    row."""
    from distributedtraining_tpu_torch.engine import serve
    from distributedtraining_tpu_torch.engine import speculative as spec
    from distributedtraining_tpu_torch.models import gpt2
    cfg = dataclasses.replace(gpt2.PRESETS["gpt2-124m"], dtype="float32")
    model, _ = gpt2.make_model(cfg)
    state = gpt2.params_from_numpy(tree, device=DEV)
    lanes = [(0.8 if i % 2 else 0.0, 0.9, 100 + i)
             for i in range(len(prompts))]

    def run(draft):
        eng = serve.GenerationEngine(model, state, device=DEV,
                                     prefix_cache=True, draft=draft,
                                     debug_invariants=True)
        try:
            reqs = [eng.submit(p, 32, temperature=t, top_p=tp, seed=s)
                    for p, (t, tp, s) in zip(prompts, lanes)]
            while not all(r.done_evt.is_set() for r in reqs):
                eng.step()
            return [r.tokens for r in reqs], eng
        finally:
            eng.close()

    off, _ = run(None)
    rows: list = []
    undo = _record_sampled_rows(rows)
    try:
        on, eng_on = run(spec.DraftEngine(model, state, device=DEV))
    finally:
        undo()
    check(eng_on._spec_proposed > 0 and eng_on.verify_dispatches > 0
          and eng_on.spec_fallbacks == 0,
          f"f32 self-draft: proposed {eng_on._spec_proposed}, verifies "
          f"{eng_on.verify_dispatches}, fallbacks {eng_on.spec_fallbacks}")
    readings = _sampled_pair_readings(rows)
    del rows
    check(readings["pairs"] > 0, "f32 self-draft: no sampled proposal")
    check(readings["differ_same_order"] == 0,
          f"f32 self-draft: sampled picks differ on rows that rank the "
          f"kept tokens alike: {readings}")
    wrong = spec.ScriptedDraftSource(
        lambda req, k: [(len(req.tokens) * 7919 + i) % cfg.vocab_size
                        for i in range(k)])
    zero, eng_zero = run(wrong)
    check(eng_zero._spec_proposed > 0 and eng_zero._spec_accepted == 0
          and eng_zero.spec_fallbacks == 0,
          f"scripted drafter accepted {eng_zero._spec_accepted} of "
          f"{eng_zero._spec_proposed} ({eng_zero.spec_fallbacks} "
          f"fallbacks)")
    greedy = [i for i, (t, _, _) in enumerate(lanes) if t == 0.0]
    for name, out in (("self-draft", on), ("zero-accept", zero)):
        check(all(out[i] == off[i] for i in greedy),
              f"f32 {name} greedy streams differ from spec-off")
    undo = _decode_through_window()
    try:
        off_w, _ = run(None)
    finally:
        undo()

    def agree(a, b):
        pairs = [(x, y) for i in range(len(a)) if lanes[i][0] > 0
                 for x, y in zip(a[i], b[i])]
        return sum(x == y for x, y in pairs) / len(pairs)

    return {"greedy_identical": True, "lanes": len(lanes),
            "greedy_lanes": len(greedy),
            "proposed_self_draft": eng_on._spec_proposed,
            "spec_fallbacks": eng_on.spec_fallbacks,
            "accept_rate_self_draft": eng_on.spec_accept_rate,
            "accept_rate_scripted": eng_zero.spec_accept_rate,
            "sampled_agreement_self_draft": agree(on, off),
            "sampled_agreement_zero_accept": agree(zero, off),
            "sampled_pairs": readings,
            # one attention kernel on both sides
            "witness_sampled_agreement_zero_accept_vs_window_decode":
                agree(zero, off_w),
            "witness_sampled_agreement_decode_vs_window_decode":
                agree(off, off_w)}


def _server_cli(argv, port, bodies, publish=None, timeout=600.0) -> dict:
    """``neurons.server.main`` on a thread, the launch counts set to 0
    just before and read after it returns: the ``bodies`` POSTed at once
    (after /healthz answers). With ``publish``, a second client keeps one
    request in flight at a time from then on, ``publish`` is called once
    the engine has emitted tokens, and the client stops at the first
    answer that names the new revision (a 503 while the swap drains is
    counted). The engines and drafters the CLI builds and the traces it
    finishes are captured by hooks."""
    import threading
    import torch
    from distributedtraining_tpu_torch.engine import serve
    from distributedtraining_tpu_torch.engine import speculative as spec
    from distributedtraining_tpu_torch.neurons import server as server_cli
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.ops import paged_attention as pa
    from distributedtraining_tpu_torch.utils import reqtrace
    seen = {"engines": [], "drafts": [], "traces": []}
    undo = []

    def hook(cls, name, note):
        real = getattr(cls, name)

        def wrapper(obj, *a, **kw):
            out = real(obj, *a, **kw)
            note(obj, out)
            return out
        setattr(cls, name, wrapper)
        undo.append((cls, name, real))

    hook(serve.GenerationEngine, "__init__",
         lambda e, out: seen["engines"].append(e))
    hook(spec.DraftEngine, "__init__",
         lambda d, out: seen["drafts"].append(d))
    hook(reqtrace.TraceBook, "finish",
         lambda b, out: out is not None and seen["traces"].append(out))
    rc: dict = {}
    traffic = {"answers": [], "drain_503": 0}
    stop = threading.Event()
    rev2 = None

    def client():
        # one request at a time until the new revision answers
        body = {**bodies[0], "max_new_tokens": 32}
        while not stop.is_set():
            try:
                _, out = _post(port, body)
            except urllib.error.HTTPError as e:
                check(e.code == 503, f"server CLI answered {e.code}")
                traffic["drain_503"] += 1
                time.sleep(0.05)
                continue
            traffic["answers"].append(out["revision"])
            if rev2 is not None and out["revision"] == rev2:
                return

    try:
        torch.cuda.synchronize()
        _zero_counts()
        dsc.launches = pa.launches = pa.window_launches = 0
        t0 = time.perf_counter()
        th = threading.Thread(
            target=lambda: rc.setdefault("rc", server_cli.main(argv)),
            name="smoke-server", daemon=True)
        th.start()
        _wait_health(port, th, f"the server CLI ({rc})", timeout)
        boot_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(bodies) + 1) as ex:
            futs = [ex.submit(_post, port, b) for b in bodies]
            if publish is not None:
                while not seen["engines"][0].tokens_emitted:
                    time.sleep(0.005)
                side = ex.submit(client)
                rev2 = publish()
            results = [f.result() for f in futs]
            wall = time.perf_counter() - t1
            # every token served in the window, a side client's included
            emitted = seen["engines"][0].tokens_emitted
            if publish is not None:
                side.result(timeout=timeout)
        th.join(timeout)
        check(not th.is_alive() and rc.get("rc") == 0,
              f"server CLI did not exit 0: {rc}")
        torch.cuda.synchronize()
    finally:
        stop.set()
        for cls, name, real in undo:
            setattr(cls, name, real)
    ids = {out["request_id"] for _, out in results}
    return {"rc": rc["rc"], "boot_s": boot_s, "wall_s": wall,
            "tokens_in_wall": emitted, "results": results, "rev2": rev2, "traffic": traffic,
            "engine": seen["engines"][0],
            "draft": seen["drafts"][0] if seen["drafts"] else None,
            "traces": [(tr.ttft_ms, tr.tpot_ms) for tr in seen["traces"]
                       if tr.request_id in ids],
            # each traced request's prefill stage (pfx_hit, pfx_tokens,
            # prompt_tokens, dur_ms), in the order of "traces"
            "prefills": [next((st for st in tr.stages
                               if st["stage"] == "prefill"), None)
                         for tr in seen["traces"] if tr.request_id in ids],
            "launches": {"paged_decode_attention": pa.launches,
                         "paged_window_attention": pa.window_launches,
                         "dequant_scatter": dsc.launches, **fa.launches,
                         **fused_ce.launches}}


def _pct(vals, q) -> float:
    vals = sorted(v for v in vals if v is not None)
    k = (len(vals) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (k - lo)


def _serve6_traffic(vocab: int) -> tuple[list, list]:
    """Phase 21's requests: 8 prompts sharing a 512-token system prompt,
    each with its own suffix (3-120 tokens); even lanes greedy, odd ones
    sampled (temperature 0.8, top_p 0.9, distinct seeds); 32 new tokens
    each. Returns (prompts, request bodies)."""
    rng_sys = _prompts((512,), vocab, SEED + 21)[0]
    suffixes = _prompts((3, 9, 17, 30, 48, 64, 90, 120), vocab, SEED + 22)
    prompts = [rng_sys + s for s in suffixes]
    bodies = [{"tokens": p, "max_new_tokens": 32,
               **({"temperature": 0.8, "top_p": 0.9, "seed": 1000 + i}
                  if i % 2 else {})}
              for i, p in enumerate(prompts)]
    return prompts, bodies


def _serve_prefix_hits(tree) -> dict:
    """Phase 21's traffic once through ``neurons.server.main`` with the
    JAX server's defaults (the prefix cache on): for each request whose
    prefill hit the cache (a suffix prefill: 12 window launches) its
    ttft and its prefill's ms, from the request traces."""
    import tempfile
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    _, bodies = _serve6_traffic(gpt2.PRESETS["gpt2-124m"].vocab_size)
    with tempfile.TemporaryDirectory() as work:
        LocalFSTransport(os.path.join(work, "artifacts")).publish_base(tree)
        port = _free_port()
        run = _server_cli(["--work-dir", work, "--dataset", "synthetic",
                           "--tokenizer", "word", "--serve-port", str(port),
                           "--swap-poll", "1", "--max-steps", "100000"],
                          port, bodies, None)
    hits = [(tt, st) for (tt, _), st in zip(run["traces"], run["prefills"])
            if st is not None and st.get("pfx_hit")]
    check(hits, "--window-ab: no request hit the prefix cache")
    return {"prefix_hits": len(hits),
            "suffix_tokens": [st["prompt_tokens"] - st["pfx_tokens"]
                              for _, st in hits],
            "ttft_ms": [tt for tt, _ in hits],
            "prefill_ms": [st["dur_ms"] for _, st in hits],
            "ttft_ms_p50": _pct([tt for tt, _ in hits], 50),
            "prefill_ms_p50": _pct([st["dur_ms"] for _, st in hits], 50),
            "window_launches": run["launches"]["paged_window_attention"]}


def phase_server(tree) -> dict:
    """The server CLI at GPT-2-124M with the JAX server's default flags
    (prefix cache and traces on; only the corpus, the tokenizer, the
    port, a 1 s swap poll and a bound on steps given) on a LocalFS root
    whose base the port's transport published: 8 concurrent requests
    sharing a 512-token system prompt, each with its own suffix, greedy
    and sampled lanes (temperature 0.8, top_p 0.9, distinct seeds), 32
    new tokens each: once alone ("plain", the serving numbers), once
    with --speculative (self-draft, --draft-k 4; it must draft: a ready
    drafter, proposals, drafter steps, verifies and no fallback), and
    once with a second base published mid-run and swapped in under drain
    ("default": its times share the host with the publish and a side
    client). Launch counts exact for every run."""
    import tempfile
    from distributedtraining_tpu_torch import serialization as ser
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    cfg = gpt2.PRESETS["gpt2-124m"]
    L = cfg.n_layer
    # the second base, serialized before the run: publishing it mid-run
    # is then one atomic file write, as another process's publish is
    second = ser.to_msgpack(gpt2.init_params_numpy(cfg, SEED + 5))
    prompts, bodies = _serve6_traffic(cfg.vocab_size)
    res: dict = {"model": "gpt2-124m", "dtype": cfg.dtype,
                 "prompts": [len(p) for p in prompts], "new_tokens": 32}
    res["spec_f32"] = _spec_parity_f32(_sharpened(tree), prompts[:4])
    with tempfile.TemporaryDirectory() as work:
        t = LocalFSTransport(os.path.join(work, "artifacts"))
        rev1 = t.publish_base(tree)
        runs = {}
        for name, extra, publish in (
                ("plain", [], None),
                ("speculative", ["--speculative", "--draft-k", "4"], None),
                ("default", [], lambda: t.publish_base_raw(second))):
            port = _free_port()
            argv = ["--work-dir", work, "--dataset", "synthetic",
                    "--tokenizer", "word", "--serve-port", str(port),
                    "--swap-poll", "1", "--max-steps", "100000"] + extra
            run = _server_cli(argv, port, bodies, publish)
            eng, draft = run["engine"], run["draft"]
            for (code, out), p in zip(run["results"], prompts):
                check(code == 200 and out["status"] == "done"
                      and len(out["tokens"]) == 32,
                      f"{name}: request not done: {code} {out}")
                check(out["revision"] == rev1,
                      f"{name}: answered on {out['revision']}, not the "
                      f"boot base {rev1}")
                check(all(0 <= x < cfg.vocab_size for x in out["tokens"]),
                      f"{name}: token outside the vocabulary")
            check(eng.prefix_hits >= len(prompts) - 1,
                  f"{name}: prefix hits {eng.prefix_hits}")
            eng._check_invariants()     # refcounts == cache holders
            dec = eng.decode_dispatches + (draft.step_dispatches
                                           if draft else 0)
            win = eng.suffix_prefills + eng.verify_dispatches
            full = eng.full_prefills + (draft.prefill_dispatches
                                        if draft else 0)
            want = {"paged_decode_attention": L * dec,
                    "paged_window_attention": L * win,
                    "flash_attention_fwd": L * full}
            _check_launches(f"server {name}", run["launches"], want)
            check(dec > 0 and win > 0 and full > 0,
                  f"server {name}: a kernel of the path never ran")
            if name == "speculative":
                check(draft is not None and draft.ready
                      and eng._draft is draft and eng.verify_dispatches > 0
                      and eng._spec_proposed > 0
                      and draft.step_dispatches > 0
                      and eng.spec_fallbacks == 0,
                      f"server speculative: it did not draft (drafter "
                      f"{draft}, ready {draft and draft.ready}, verifies "
                      f"{eng.verify_dispatches}, proposed "
                      f"{eng._spec_proposed}, fallbacks "
                      f"{eng.spec_fallbacks})")
            ttft = [tt for tt, _ in run["traces"]]
            tpot = [tp for _, tp in run["traces"]]
            runs[name] = {
                "boot_s": run["boot_s"], "wall_s": run["wall_s"],
                "tokens_in_wall": run["tokens_in_wall"],
                "tokens_per_s": run["tokens_in_wall"] / run["wall_s"],
                "publish_during_run": publish is not None,
                "ttft_ms_p50": _pct(ttft, 50), "ttft_ms_p95": _pct(ttft, 95),
                "tpot_ms_p50": _pct(tpot, 50), "tpot_ms_p95": _pct(tpot, 95),
                "prefix_hit_rate": eng.prefix_hit_rate,
                "prefix_hits": eng.prefix_hits,
                "prefix_tokens_saved": eng.prefix_tokens_saved,
                "cow_copies": eng.cow_copies,
                "accept_rate": eng.spec_accept_rate if draft else None,
                "spec_rounds": eng.spec_rounds,
                "spec_proposed": eng._spec_proposed,
                "spec_fallbacks": eng.spec_fallbacks,
                "dispatches": {"decode_target": eng.decode_dispatches,
                               "decode_draft": (draft.step_dispatches
                                                if draft else 0),
                               "verify": eng.verify_dispatches,
                               "suffix_prefill": eng.suffix_prefills,
                               "full_prefill": eng.full_prefills,
                               "draft_prefill": (draft.prefill_dispatches
                                                 if draft else 0)},
                "launches": run["launches"],
                "tokens": [out["tokens"] for _, out in run["results"]]}
            if publish is not None:
                answers = run["traffic"]["answers"]
                check(answers and answers[-1] == run["rev2"]
                      and eng.revision == run["rev2"],
                      f"the swap to {run['rev2']} did not land: {answers}")
                runs[name].update(
                    swapped_to=run["rev2"],
                    answers_before_swap=answers.count(rev1),
                    drain_503=run["traffic"]["drain_503"])
    on, off = runs["speculative"]["tokens"], runs["plain"]["tokens"]
    pairs = [(x, y) for a, b in zip(on, off) for x, y in zip(a, b)]
    res["bf16_spec_agreement"] = sum(x == y for x, y in pairs) / len(pairs)
    res["bf16_spec_agreement_greedy"] = (
        sum(x == y for i, (a, b) in enumerate(zip(on, off)) if not i % 2
            for x, y in zip(a, b)) / (32 * len(prompts[::2])))
    for r in runs.values():
        r.pop("tokens")
    res["runs"] = runs
    log("server phase:", json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# 22. serve6b: disaggregated prefill/decode, the router, load, genetic
# ---------------------------------------------------------------------------

S6B_SUFFIXES = (3, 9, 17, 30, 48, 64, 90, 120)
S6B_NEW = 32
LOAD_RATES = (4.0, 16.0, 40.0)
LOAD_BUSY = 4


def _s6b_traffic(vocab: int):
    """Phase 21's traffic: 8 prompts sharing a 512-token system prompt,
    suffixes of 3-120 tokens; odd lanes sampled (temperature 0.8, top_p
    0.9). Every lane has its own seed, so recorded rows pair by (seed,
    token index). Returns the prompts and the ``(temperature, top_p,
    seed)`` of each lane."""
    sys_p = _prompts((512,), vocab, SEED + 21)[0]
    prompts = [sys_p + s for s in _prompts(S6B_SUFFIXES, vocab, SEED + 22)]
    lanes = [(0.8, 0.9, 1000 + i) if i % 2 else (0.0, 1.0, 1000 + i)
             for i in range(len(prompts))]
    return prompts, lanes


def _record_rows(store: dict, side: list):
    """Patch ``serve._pick`` so that every row a lane picks from is kept
    as ``store[(side[0], seed, n)]`` for its n-th pick on that side (its
    n-th token: the rows pair by order, not by the keys under test): the
    f32 logits and the pick (``side[0]`` None: nothing kept; padded
    lanes, seed 0, never). Returns the undo."""
    import numpy as np
    from distributedtraining_tpu_torch.engine import serve
    real = serve._pick
    nth: dict = {}

    def pick(logits, temps, top_ps, seeds, tok_idx):
        out = real(logits, temps, top_ps, seeds, tok_idx)
        if side[0] is not None:
            for r in np.flatnonzero(np.asarray(seeds) != 0):
                lane = (side[0], int(seeds[r]))
                nth[lane] = nth.get(lane, -1) + 1
                store[(*lane, nth[lane])] = {
                    "row": logits[int(r)].float().clone(),
                    "pick": int(out[r])}
        return out

    serve._pick = pick
    return lambda: setattr(serve, "_pick", real)


def _divergence_readings(store: dict, side_a: str, side_b: str,
                         streams_a, streams_b, lanes) -> dict:
    """Two runs of the same requests, token for token: the agreement,
    and each request's FIRST differing token (the same tokens before it)
    held to phase 21's near-tie rule with the rows each side picked it
    from. The pair is a fault when the two rows rank the kept tokens
    alike (greedy: the argmax; sampled: the top_p set), since then only
    the keys or the sampler could part them, or when the winner's logit
    gap to a rank neighbour (side b's row) exceeds twice the rows' max
    |logit difference|."""
    same = total = 0
    parted, faults = [], []
    for (a, b), (temp, top_p, seed) in zip(zip(streams_a, streams_b),
                                           lanes):
        total += min(len(a), len(b))
        same += sum(x == y for x, y in zip(a, b))
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        ra, rb = store.get((side_a, seed, j)), store.get((side_b, seed, j))
        check(ra is not None and rb is not None and ra["pick"] == a[j]
              and rb["pick"] == b[j],
              f"lane {seed} token {j}: the rows of the differing picks "
              f"were not recorded")
        t, tp = (temp, top_p) if temp > 0 else (1.0, 1e-9)
        _, oa, ka = _ranked(ra["row"], t, tp)
        sb, ob, kb = _ranked(rb["row"], t, tp)
        k = max(ka, kb)
        alike = ka == kb and bool((oa[:k] == ob[:k]).all())
        delta = float((ra["row"] - rb["row"]).abs().max())
        ranked = sb[ob]
        rv = int((ob == b[j]).nonzero()[0, 0])
        near = [float(ranked[rv - 1] - ranked[rv])] if rv > 0 else []
        if rv + 1 < ranked.numel():
            near.append(float(ranked[rv] - ranked[rv + 1]))
        gap = min(near) * t
        entry = {"seed": seed, "token": j, "sampled": temp > 0,
                 "rows_rank_alike": alike, "max_dlogit": delta,
                 "winner_gap": gap}
        parted.append(entry)
        if alike or gap > 2 * delta:
            faults.append(entry)
    return {"agreement": same / total if total else 1.0,
            "requests_parted": len(parted), "faults": faults,
            "parted": parted}


def _disagg_parity(cfg, tree, prompts, lanes, device, *,
                   new: int = S6B_NEW) -> dict:
    """A prefill worker (prefix cache on) and a decode worker over an
    in-memory transport against a unified engine (prefix cache on), the
    same requests in the same order, at ``cfg``'s dtype on ``device``:
    every request adopted with no re-prefill, the pools audited every
    step, greedy lanes token identical, and each request's first
    differing token (if any) a near-tie (:func:`_divergence_readings`)."""
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.engine import kv_transfer as kvt
    from distributedtraining_tpu_torch.engine import serve
    from distributedtraining_tpu_torch.transport import InMemoryTransport
    model, _ = models.make_model(cfg)
    # a numpy tree, or a state dict already placed
    state = tree if not any(isinstance(v, dict) for v in tree.values()) \
        else models.params_from_numpy(tree, device=device)
    store: dict = {}
    side = [None]
    undo = _record_rows(store, side)

    def run(eng, reqs_kw):
        reqs = [eng.submit(p, new, temperature=tt, top_p=tp, seed=s, **kw)
                for p, (tt, tp, s), kw in zip(prompts, lanes, reqs_kw)]
        while not all(r.done_evt.is_set() for r in reqs):
            eng.step()
        return reqs

    kw = dict(device=device, page_size=16, prefix_cache=True,
              debug_invariants=True, revision="r0")
    tr = InMemoryTransport()
    uni = serve.GenerationEngine(model, state, **kw)
    pre = serve.GenerationEngine(model, state, phase="prefill",
                                 kv_exporter=kvt.KVExporter(tr), **kw)
    dec = serve.GenerationEngine(model, state, phase="decode",
                                 kv_adopter=kvt.KVAdopter(tr), **kw)
    try:
        side[0] = "unified"
        ref = [r.tokens for r in run(uni, [{}] * len(prompts))]
        side[0] = "disagg"
        legs = run(pre, [{}] * len(prompts))
        out = [r.tokens for r in run(dec, [
            {"kv_ref": r.kv_ref, "first_token": r.first_token}
            for r in legs])]
    finally:
        undo()
        for e in (uni, pre, dec):
            e.close()
    n = len(prompts)
    check((pre.kv_exported, dec.kv_adopted, dec.kv_reprefills,
           dec.kv_rev_mismatch) == (n, n, 0, 0),
          f"f32 pair: exported {pre.kv_exported}, adopted {dec.kv_adopted},"
          f" re-prefills {dec.kv_reprefills}, revision skews "
          f"{dec.kv_rev_mismatch} of {n}")
    check(dec.full_prefills == dec.suffix_prefills == 0
          and pre.decode_dispatches == 0,
          "f32 pair: a worker ran the other's phase")
    greedy = [i for i, (t, _, _) in enumerate(lanes) if t == 0]
    check(all(out[i] == ref[i] for i in greedy),
          f"disaggregated greedy lanes differ from the unified engine's: "
          f"{[(out[i], ref[i]) for i in greedy if out[i] != ref[i]]}")
    read = _divergence_readings(store, "disagg", "unified", out, ref, lanes)
    check(not read["faults"],
          f"a differing token that is no near-tie: {read['faults']}")
    return {"dtype": cfg.dtype, "requests": n, "new_tokens": new,
            "greedy_identical": True, "adopted": dec.kv_adopted,
            "suffix_prefills": pre.suffix_prefills,
            "full_prefills": pre.full_prefills,
            "sampled_agreement": (
                sum(x == y for i in range(n) if i not in greedy
                    for x, y in zip(out[i], ref[i]))
                / max(1, new * (n - len(greedy)))),
            **{k: read[k] for k in ("agreement", "requests_parted",
                                    "parted")}}


def _plant_torn_page(t, kv_ref: str):
    """Change one byte of the LAST page a request's manifest lists, in
    the store itself (the page no earlier request shares, so no page
    store holds it). Returns the undo."""
    from distributedtraining_tpu_torch.engine import kv_transfer as kvt
    from distributedtraining_tpu_torch.transport import base as tbase
    man = kvt.parse_kv_manifest(tbase.fetch_kv_manifest_bytes(t, kv_ref))
    digest = man["pages"][-1][0]
    good = tbase.fetch_kv_page(t, digest)
    bad = bytearray(good)
    bad[len(bad) // 2] ^= 0xFF
    t.publish_raw(tbase.kv_page_id(digest), bytes(bad))
    return lambda: t.publish_raw(tbase.kv_page_id(digest), good)


def _plant_revision_skew(t, kv_ref: str):
    """Republish a request's manifest naming another base revision, its
    pages untouched. Returns the undo."""
    from distributedtraining_tpu_torch.engine import kv_transfer as kvt
    from distributedtraining_tpu_torch.transport import base as tbase
    raw = tbase.fetch_kv_manifest_bytes(t, kv_ref)
    man = kvt.parse_kv_manifest(raw)
    tbase.publish_kv_manifest(t, kv_ref, kvt.build_kv_manifest(
        request_id=man["request_id"], revision=man["revision"] + "-skewed",
        pages=man["pages"], geometry=man["geometry"],
        prompt_len=man["prompt_len"], first_token=man["first_token"]))
    return lambda: tbase.publish_kv_manifest(t, kv_ref, raw)


def _planted_degrades(t, prefill, decode, dec, prompts, n_layer,
                      launches=None) -> dict:
    """A planted torn page, then a planted revision skew, each on a
    fresh request (``prefill(prompt) -> (kv_ref, first_token)``,
    ``decode(prompt, kv_ref, first_token) -> tokens``, ``dec`` the decode
    worker's engine): exactly one counted re-prefill (and one revision
    skew), one prefill forward on the decode worker (on the card: 12
    flash or window launches, and 12 paged launches a decode dispatch;
    ``launches()`` zeroes and reads the counts). With the plant undone,
    the same request adopts and emits the same tokens."""
    out: dict = {}
    for (name, plant), prompt in zip((("torn_page", _plant_torn_page),
                                      ("revision_skew",
                                       _plant_revision_skew)), prompts):
        kv_ref, first = prefill(prompt)
        undo = plant(t, kv_ref)
        c0 = (dec.kv_reprefills, dec.kv_rev_mismatch, dec.kv_adopted,
              dec.full_prefills + dec.suffix_prefills, dec.decode_dispatches)
        if launches is not None:
            launches(zero=True)
        bad = decode(prompt, kv_ref, first)
        got = launches() if launches is not None else None
        c1 = (dec.kv_reprefills, dec.kv_rev_mismatch, dec.kv_adopted,
              dec.full_prefills + dec.suffix_prefills, dec.decode_dispatches)
        want = (c0[0] + 1, c0[1] + (name == "revision_skew"), c0[2],
                c0[3] + 1)
        check(c1[:4] == want,
              f"planted {name}: (re-prefills, skews, adoptions, prefills) "
              f"{c1[:4]} != {want}")
        if got is not None:
            steps = c1[4] - c0[4]
            check(got["flash_attention_fwd"] + got["paged_window_attention"]
                  == n_layer and got["paged_decode_attention"]
                  == n_layer * steps,
                  f"planted {name}: launches {got} != {n_layer} prefill + "
                  f"{n_layer} x {steps} decode")
        undo()
        good = decode(prompt, kv_ref, first)
        check(dec.kv_adopted == c0[2] + 1 and dec.kv_reprefills == c1[0],
              f"planted {name}: the restored transfer was not adopted")
        check(bad == good, f"planted {name}: the re-prefill changed the "
                           f"output: {bad} vs {good}")
        out[name] = {"reprefills": 1, "launches": got, "tokens_equal": True}
    return out


def _s6b_launches():
    """A ``launches(zero=False)`` reader over the kernels the serving
    path can run (flash, paged decode and window, CE, scatter)."""
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.ops import paged_attention as pa
    import torch

    def launches(zero: bool = False) -> dict:
        torch.cuda.synchronize()
        if zero:
            _zero_counts()
            dsc.launches = pa.launches = pa.window_launches = 0
        return {"paged_decode_attention": pa.launches,
                "paged_window_attention": pa.window_launches,
                "dequant_scatter": dsc.launches, **fa.launches,
                **fused_ce.launches}
    return launches


def _wait_health(port: int, th, what: str, timeout: float = 600.0) -> dict:
    deadline = time.time() + timeout
    while True:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=5) as r:
                return json.loads(r.read())
        except OSError:
            check(th.is_alive() and time.time() < deadline,
                  f"{what} never answered /healthz")
            time.sleep(0.1)


def _s6b_cli(tree, prompts, lanes) -> dict:
    """The disaggregated fleet through its CLIs on one LocalFS root: a
    ``--serve-phase prefill`` worker, a ``--serve-phase decode`` worker
    and a unified worker (``neurons.server.main``, the JAX defaults:
    prefix cache and traces on), and ``neurons.router.main`` in front of
    the three. Phase 21's traffic through the router (every request two
    legs, launch counts exact per worker), then directly to the unified
    worker (the agreement, the near-tie rule), then the planted torn page
    and revision skew on the pair. Returns the readings and the threads
    to join (the workers end after 20 s idle)."""
    import math
    import threading
    import torch
    from distributedtraining_tpu_torch.engine import kv_transfer as kvt
    from distributedtraining_tpu_torch.engine import router as rmod
    from distributedtraining_tpu_torch.engine import serve
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.neurons import router as router_cli
    from distributedtraining_tpu_torch.neurons import server as server_cli
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    import tempfile
    cfg = gpt2.PRESETS["gpt2-124m"]
    L, P = cfg.n_layer, 16
    work = tempfile.mkdtemp(prefix="s6b-")
    t = LocalFSTransport(os.path.join(work, "artifacts"))
    rev = t.publish_base(tree)
    launches = _s6b_launches()
    seen = {"engines": [], "routers": [], "export_ms": [], "adopt_ms": [],
            "router_added_ms": []}
    local = threading.local()
    undo = []

    def hook(cls, name, after):
        real = getattr(cls, name)

        def wrapper(obj, *a, **kw):
            t0 = time.perf_counter()
            out = real(obj, *a, **kw)
            after(obj, out, (time.perf_counter() - t0) * 1e3)
            return out
        setattr(cls, name, wrapper)
        undo.append((cls, name, real))

    hook(serve.GenerationEngine, "__init__",
         lambda e, out, ms: seen["engines"].append(e))
    hook(rmod.RouterHTTPFrontend, "__init__",
         lambda r, out, ms: seen["routers"].append(r))
    # export: the device-to-host copy, packing, hashing and the writes;
    # adoption: fetch, hash check, unpack and the host-to-device write
    hook(serve.GenerationEngine, "_finish_prefill",
         lambda e, out, ms: seen["export_ms"].append(ms))
    hook(serve.GenerationEngine, "_try_adopt",
         lambda e, out, ms: seen["adopt_ms"].append(ms))

    def leg(r, out, ms):
        local.legs_ms = getattr(local, "legs_ms", 0.0) + ms
    hook(rmod.RouterHTTPFrontend, "_fetch_json", leg)
    real_route = rmod.RouterHTTPFrontend._route

    def route(r, *a, **kw):
        local.legs_ms = 0.0
        t0 = time.perf_counter()
        out = real_route(r, *a, **kw)
        seen["router_added_ms"].append(
            (time.perf_counter() - t0) * 1e3 - local.legs_ms)
        return out
    rmod.RouterHTTPFrontend._route = route
    undo.append((rmod.RouterHTTPFrontend, "_route", real_route))

    store: dict = {}
    side = [None]
    undo_rows = _record_rows(store, side)
    threads, rcs = {}, {}
    res: dict = {"revision": rev}
    try:
        ports = {}
        t0 = time.perf_counter()
        for phase in ("prefill", "decode", "unified"):
            ports[phase] = _free_port()
            argv = ["--work-dir", work, "--dataset", "synthetic",
                    "--tokenizer", "word", "--serve-port",
                    str(ports[phase]), "--swap-poll", "10", "--max-steps",
                    "1000000", "--serve-phase", phase]
            threads[phase] = threading.Thread(
                target=lambda p=phase, a=argv: rcs.setdefault(
                    p, server_cli.main(a)), name=f"s6b-{phase}", daemon=True)
            threads[phase].start()
        for phase, port in ports.items():
            hz = _wait_health(port, threads[phase], f"the {phase} worker")
            check(hz["phase"] == phase and hz["revision"] == rev,
                  f"the {phase} worker's /healthz: {hz}")
        res["boot_s"] = time.perf_counter() - t0
        engines = {e.phase: e for e in seen["engines"]}
        check(sorted(engines) == ["decode", "prefill", "unified"]
              and len(seen["engines"]) == 3,
              f"the CLIs built {[e.phase for e in seen['engines']]}")
        pre, dec, uni = (engines[p] for p in ("prefill", "decode",
                                              "unified"))
        check(dec._draft is None and pre._draft is None,
              "a worker built a drafter without --speculative")
        rport = _free_port()
        urls = [f"http://127.0.0.1:{ports[p]}" for p in
                ("prefill", "decode", "unified")]
        rargv = [a for u in urls for a in ("--backend", u)] + [
            "--port", str(rport), "--max-queue", "32",
            "--poll-interval", "0.5"]
        threads["router"] = threading.Thread(
            target=lambda: rcs.setdefault("router", router_cli.main(rargv)),
            name="s6b-router", daemon=True)
        threads["router"].start()
        # the router answers /healthz before its first sweep has read
        # the backends: wait for a view with all three healthy
        deadline = time.time() + 60
        while True:
            rhz = _wait_health(rport, threads["router"], "the router")
            if all(b["healthy"] for b in rhz["backends"]):
                break
            check(time.time() < deadline, f"the router's view: {rhz}")
            time.sleep(0.1)
        check(sorted(b["phase"] for b in rhz["backends"]) ==
              ["decode", "prefill", "unified"], f"the router's view: {rhz}")
        router = seen["routers"][0]
        bodies = [{"tokens": p, "max_new_tokens": S6B_NEW, "temperature": tt,
                   "top_p": tp, "seed": s}
                  for p, (tt, tp, s) in zip(prompts, lanes)]

        def burst(port):
            with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
                t0 = time.perf_counter()
                outs = list(ex.map(lambda b: _post(port, b)[1], bodies))
                return outs, time.perf_counter() - t0

        # the main path: through the router, counts zeroed just before
        side[0] = "disagg"
        launches(zero=True)
        routed, wall = burst(rport)
        got = launches()
        side[0] = None
        n = len(bodies)
        for out in routed:
            check(out["status"] == "done" and len(out["tokens"]) == S6B_NEW
                  and out["revision"] == rev
                  and out.get("prefill_backend") == urls[0]
                  and out.get("backend") == urls[1],
                  f"a request did not route disaggregated: {out}")
        check((router.disagg_routed, router.disagg_fallbacks, router.shed)
              == (n, 0, 0),
              f"router: disaggregated {router.disagg_routed}, fallbacks "
              f"{router.disagg_fallbacks}, shed {router.shed}")
        check((pre.kv_exported, dec.kv_adopted, dec.kv_reprefills,
               dec.kv_rev_mismatch, uni.tokens_emitted) == (n, n, 0, 0, 0),
              f"exported {pre.kv_exported}, adopted {dec.kv_adopted}, "
              f"re-prefills {dec.kv_reprefills}, skews "
              f"{dec.kv_rev_mismatch}, unified tokens {uni.tokens_emitted}")
        check(dec.full_prefills == dec.suffix_prefills == 0
              and pre.decode_dispatches == pre.verify_dispatches == 0
              and pre.full_prefills + pre.suffix_prefills == n,
              "a worker ran the other's phase")
        # every worker in one process: the counts are shared, and each
        # kernel is one worker's (the prefill worker runs no decode, the
        # decode worker no prefill, the unified worker nothing)
        want = {"flash_attention_fwd": L * pre.full_prefills,
                "paged_window_attention": L * pre.suffix_prefills,
                "paged_decode_attention": L * dec.decode_dispatches}
        _check_launches("serve6b router traffic", got, want)
        check(all(want.values()), f"a kernel of the path never ran: {want}")
        # the dedupe: the shared system prompt's 32 pages ship once
        ex, ad = pre._kv_exporter, dec._kv_adopter
        page_bytes = len(kvt.pack_kv_page(*(torch.zeros(
            L, P, cfg.n_head, cfg.head_dim, dtype=torch.bfloat16),) * 2))
        shared = 512 // P
        unique = shared + sum(math.ceil(len(p) / P) - shared
                              for p in prompts)
        manifests = sum(len(t.fetch_delta_bytes(
            f"__kv__.{out['request_id']}") or b"") for out in routed)
        check(len(ex._published) == unique
              and ex.bytes_published == unique * page_bytes + manifests
              and ad.bytes_fetched == unique * page_bytes,
              f"export dedupe: {len(ex._published)} digests (want "
              f"{unique}), {ex.bytes_published} bytes published, "
              f"{ad.bytes_fetched} fetched, page {page_bytes} B")
        res["router_traffic"] = {
            "wall_s": wall, "launches": got, "requests": n,
            "disagg_routed": router.disagg_routed,
            "disagg_fallbacks": router.disagg_fallbacks,
            "kv_adopted": dec.kv_adopted, "kv_reprefills": dec.kv_reprefills,
            "kv_rev_mismatch": dec.kv_rev_mismatch,
            "prefills": {"full": pre.full_prefills,
                         "suffix": pre.suffix_prefills},
            "decode_dispatches": dec.decode_dispatches,
            "kv_page_bytes": page_bytes, "unique_pages": unique,
            "kv_bytes_published": ex.bytes_published,
            "kv_bytes_fetched": ad.bytes_fetched,
            "kv_bytes_first_request": math.ceil(len(prompts[0]) / P)
            * page_bytes,
            "kv_bytes_per_request_deduped": [
                (math.ceil(len(p) / P) - shared) * page_bytes
                for p in prompts[1:]],
            "export_ms": list(seen["export_ms"]),
            "adopt_ms": list(seen["adopt_ms"]),
            "router_added_ms": list(seen["router_added_ms"])}
        # the same requests straight to the unified worker
        side[0] = "unified"
        launches(zero=True)
        direct, uwall = burst(ports["unified"])
        got_u = launches()
        side[0] = None
        _check_launches("serve6b unified worker", got_u, {
            "flash_attention_fwd": L * uni.full_prefills,
            "paged_window_attention": L * uni.suffix_prefills,
            "paged_decode_attention": L * uni.decode_dispatches})
        read = _divergence_readings(store, "disagg", "unified",
                                    [o["tokens"] for o in routed],
                                    [o["tokens"] for o in direct], lanes)
        check(not read["faults"],
              f"bf16: a differing token that is no near-tie: "
              f"{read['faults']}")
        greedy = [i for i, (tt, _, _) in enumerate(lanes) if tt == 0]
        res["unified_traffic"] = {
            "wall_s": uwall, "launches": got_u,
            "agreement_bf16": read["agreement"],
            "agreement_bf16_greedy": sum(
                x == y for i in greedy for x, y in
                zip(routed[i]["tokens"], direct[i]["tokens"]))
            / (S6B_NEW * len(greedy)),
            "requests_parted": read["requests_parted"],
            "parted": read["parted"]}
        # the planted defects, on fresh suffixes (new tail pages)
        fresh = [prompts[0][:512] + s for s in
                 _prompts((5, 21), cfg.vocab_size, SEED + 23)]

        def prefill(prompt):
            _, leg1 = _post(ports["prefill"], {
                "tokens": prompt, "max_new_tokens": S6B_NEW}, path="/prefill")
            return leg1["kv_ref"], leg1["first_token"]

        def decode(prompt, kv_ref, first):
            _, out = _post(ports["decode"], {
                "tokens": prompt, "max_new_tokens": S6B_NEW,
                "kv_ref": kv_ref, "first_token": first})
            check(out["status"] == "done", f"decode leg: {out}")
            return out["tokens"]

        res["planted"] = _planted_degrades(t, prefill, decode, dec, fresh, L,
                                           launches)
        router.close()           # its CLI returns once the frontend closes
        threads["router"].join(30)
        check(rcs.get("router") == 0, f"router CLI: {rcs}")
    finally:
        undo_rows()
        for cls, name, real in reversed(undo):
            setattr(cls, name, real)
    res["threads"], res["rcs"], res["work"] = threads, rcs, work
    return res


def _s6b_load(tree) -> dict:
    """``run_open_loop`` on a unified engine and ``run_open_loop_disagg``
    on a prefill/decode pair (GPT-2-124M, bf16, page 16, 8 slots) at
    ``LOAD_RATES``: GPT-2's vocabulary, 16 new tokens, 20 virtual ms a
    step over 2 virtual seconds, each prefill charged ``LOAD_BUSY`` busy
    ticks (the harness's cost model of the head-of-line prefill). Times
    are virtual ms; wall seconds recorded beside them. Every arrival
    finishes or, on the pair, is shed at the harness's router bound; the
    pair adopts every hand-off (no re-prefill); launches exact."""
    from distributedtraining_tpu_torch.engine import kv_transfer as kvt
    from distributedtraining_tpu_torch.engine import serve
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.transport import InMemoryTransport
    from distributedtraining_tpu_torch.utils import loadgen
    cfg = gpt2.PRESETS["gpt2-124m"]
    L = cfg.n_layer
    model, _ = gpt2.make_model(cfg)
    state = gpt2.params_from_numpy(tree, device=DEV)
    launches = _s6b_launches()
    out = {"unified": [], "disagg": []}
    for rate in LOAD_RATES:
        spec = loadgen.OpenLoopSpec(rate_rps=rate, duration_s=2.0,
                                    seed=SEED + 31, vocab=cfg.vocab_size,
                                    max_new_tokens=16, step_ms=20.0)
        uni = serve.GenerationEngine(model, state, device=DEV,
                                     revision="r0")
        tr = InMemoryTransport()
        pre = serve.GenerationEngine(model, state, device=DEV,
                                     revision="r0", phase="prefill",
                                     kv_exporter=kvt.KVExporter(tr))
        dec = serve.GenerationEngine(model, state, device=DEV,
                                     revision="r0", phase="decode",
                                     kv_adopter=kvt.KVAdopter(tr))
        try:
            for name, run, engs in (
                    ("unified", lambda: loadgen.run_open_loop(
                        uni, spec, prefill_busy_steps=LOAD_BUSY), (uni,)),
                    ("disagg", lambda: loadgen.run_open_loop_disagg(
                        [pre], [dec], spec, prefill_busy_steps=LOAD_BUSY),
                     (pre, dec))):
                launches(zero=True)
                t0 = time.perf_counter()
                pt = run()
                wall = time.perf_counter() - t0
                got = launches()
                check(pt["unfinished"] == 0 and pt["completed"] > 0
                      and pt["completed"] + pt.get("shed", 0)
                      == pt["offered"], f"load {name} at {rate} rps: {pt}")
                _check_launches(f"load {name} at {rate} rps", got, {
                    "flash_attention_fwd": L * sum(e.full_prefills
                                                   for e in engs),
                    "paged_window_attention": L * sum(e.suffix_prefills
                                                      for e in engs),
                    "paged_decode_attention": L * sum(e.decode_dispatches
                                                      for e in engs)})
                if name == "disagg":
                    check(pt["kv_reprefills"] == 0
                          and pt["kv_adopted"] == pt["handoffs"]
                          == pt["completed"],
                          f"load disagg at {rate} rps: {pt}")
                out[name].append({
                    **{k: pt[k] for k in ("rate_rps", "offered",
                                          "completed", "steps", "tokens",
                                          "ttft_ms", "tpot_ms")},
                    # the pair's harness admits through the router
                    # policy (6 queued a worker) and sheds past it
                    **({"shed": pt["shed"], "handoffs": pt["handoffs"],
                        "kv_adopted": pt["kv_adopted"]}
                       if name == "disagg" else {}),
                    "wall_s": wall, "launches": got})
        finally:
            for e in (uni, pre, dec):
                e.close()
    out["spec"] = {"duration_s": 2.0, "step_ms": 20.0, "max_new_tokens": 16,
                   "prefill_busy_steps": LOAD_BUSY,
                   "prompt_tokens": "4-40 (bounded Pareto 1.6)",
                   "vocab": cfg.vocab_size, "seed": SEED + 31}
    return out


def _population_draws(strat, m: int, device):
    """What ``strat.first_population`` and one ``strat.breed`` (from the
    first two vectors) draw on ``device``: every key ``prng.split``
    makes, every ``prng.randint`` and ``prng.normal``, in order, as CPU
    tensors; and the population they give."""
    import torch
    from distributedtraining_tpu_torch.utils import prng
    seen: list = []
    real = {k: getattr(prng, k) for k in ("split", "randint", "normal")}

    def logged(fn):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            seen.append(out.detach().cpu())
            return out
        return wrapper

    for k, fn in real.items():
        setattr(prng, k, logged(fn))
    try:
        rng, pop = strat.first_population(prng.prng_key(strat.seed,
                                                         device=device), m)
        _, kids = strat.breed(rng, pop[:strat.elite], m)
    finally:
        for k, fn in real.items():
            setattr(prng, k, fn)
    return seen, torch.stack(pop + kids).cpu()


def _s6b_genetic(tree, tok) -> dict:
    """``neurons.averager.main --strategy genetic`` at the JAX defaults
    (population 10, 10 generations, sigma 0.1, 2 elites, screened on 2
    batches) over three honest miners' submissions (phase 17's: wire-v2
    int8, wire-v2 f32 and dense v1). The published base == base + sum_i
    w_i d_i by the plain version on the CPU within 1e-6; the flash
    forward launched exactly 12 x the candidate-batches the memo's misses
    evaluated plus the merged base's eval batches, and nothing else; the
    population's draws on the card equal the CPU's bits; the device ms of
    a candidate-batch from one profiled cohort."""
    import tempfile
    import torch
    from distributedtraining_tpu_torch import delta
    from distributedtraining_tpu_torch.engine import average
    from distributedtraining_tpu_torch.engine.batched_eval import \
        BatchedCohortEvaluator
    from distributedtraining_tpu_torch.engine.serve import \
        host_param_template
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.neurons import averager as avg_cli
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    from distributedtraining_tpu_torch.utils import prng
    cfg = gpt2.PRESETS["gpt2-124m"]
    L = cfg.n_layer
    launches = _s6b_launches()
    res: dict = {}
    with tempfile.TemporaryDirectory() as work:
        t = LocalFSTransport(os.path.join(work, "artifacts"))
        rev0 = t.publish_base(tree)
        train = _batches(tok, split="train", batch_size=MINER_B,
                         seq_len=MINER_T, n=3 * AVG_MINER_STEPS)
        t0 = time.perf_counter()
        for i, (h, v2, quant) in enumerate((("hotkey_1", True, "int8"),
                                            ("hotkey_2", True, "none"),
                                            ("hotkey_3", False, "int8"))):
            _honest_miner(t, h, train[i * AVG_MINER_STEPS:
                                      (i + 1) * AVG_MINER_STEPS],
                          wire_v2=v2, quant=quant)
        res["miners_s"] = time.perf_counter() - t0
        got: dict = {}
        real = average.GeneticMerge.merge

        def merge(strat, engine, base, stacked, ids, *, val_batches,
                  consensus=None):
            got.update(strategy=strat, ids=list(ids), engine=engine,
                       base={k: v.detach().cpu().clone()
                             for k, v in base.items()},
                       deltas=list(stacked),
                       n_val=sum(1 for _ in val_batches()),
                       held=list(val_batches()))
            t1 = time.perf_counter()
            out = real(strat, engine, base, stacked, ids,
                       val_batches=val_batches, consensus=consensus)
            torch.cuda.synchronize()
            got["merge_s"] = time.perf_counter() - t1
            got["winner"] = out[1]
            return out

        average.GeneticMerge.merge = merge
        argv = [("genetic" if f == "weighted" else f)
                for f in README_AVERAGER_FLAGS] + [
            "--eval-batches", str(VAL_EVAL_BATCHES), "--publish-policy",
            "always", "--work-dir", work, "--rounds", "1", "--hotkey",
            "hotkey_97"]
        try:
            launches(zero=True)
            t0 = time.perf_counter()
            rc = avg_cli.main(argv)
            cli_s = time.perf_counter() - t0
            cli = launches()
        finally:
            average.GeneticMerge.merge = real
        check(rc == 0 and t.base_revision() not in (None, rev0),
              f"the genetic averager CLI exited {rc} without a new base")
        strat = got["strategy"]
        check((strat.population, strat.generations, strat.sigma,
               strat.elite, strat.screen_batches, strat.batched)
              == (10, 10, 0.1, 2, 2, True),
              "the CLI's genetic merge is not at the JAX defaults")
        memo, n = strat.last_memo, got["n_val"]
        n_screen = sum(1 for _, full in memo if not full)
        n_full = sum(1 for _, full in memo if full)
        cand_batches = n_screen * min(strat.screen_batches, n) + n_full * n
        _check_launches("genetic CLI", cli, {
            "flash_attention_fwd": L * (cand_batches + n)})
        # the published base against the plain mixture at the winner
        w = got["winner"]
        base = got["base"]
        placed = [delta.place_delta(d, base) for d in got["deltas"]]
        plain = delta.weighted_merge(base, placed, w)
        pub = gpt2.params_from_numpy(t.fetch_base(host_param_template(
            gpt2.make_model(cfg)[0]))[0], device="cpu")
        err = max(float((pub[k] - plain[k]).abs().max()) for k in pub)
        check(err <= 1e-6, f"genetic: published base vs the plain mixture: "
                           f"max abs {err} > 1e-6")
        del placed, plain, pub
        # the population's draws (keys, parent picks, normals) on the
        # card against the CPU's: a first population and one breeding
        m = len(got["ids"])
        draws, pops = {}, {}
        for dev in ("cpu", DEV):
            draws[dev], pops[dev] = _population_draws(strat, m, dev)
        check(len(draws["cpu"]) == len(draws[DEV]) and all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            if a.is_floating_point() else torch.equal(a, b)
            for a, b in zip(draws["cpu"], draws[DEV])),
            "the population's draws on the card differ from the CPU's")
        # the softmax over them: exp may round apart between the devices
        pop_ulps = int((pops["cpu"].view(torch.int32).long()
                        - pops[DEV].view(torch.int32).long()).abs().max())
        # one profiled cohort: device ms a candidate-batch
        eng = got["engine"]
        dev_base = {k: v.to(DEV) for k, v in base.items()}
        dplaced = [delta.place_delta(d, dev_base) for d in got["deltas"]]
        rows = pops["cpu"][:strat.population]
        cands = delta.combine_candidate_deltas(dev_base, dplaced, rows)
        held = got["held"][:strat.screen_batches]
        prof, _ = _device_profile(lambda: BatchedCohortEvaluator(
            eng).evaluate_stacked(dev_base, cands, len(cands), held))
        per = len(cands) * len(held)
        prof["device_ms_per_candidate_batch"] = (
            (prof["device_ms"] - prof["h2d_copy_ms"]) / per)
        del dev_base, dplaced, cands
        res.update({
            "cli_s": cli_s, "merge_s": got["merge_s"], "launches": cli,
            "memo": {"screen": n_screen, "full": n_full},
            "val_batches": n, "candidate_batches": cand_batches,
            "winner": [float(x) for x in w], "published_vs_plain_max_abs":
                err, "draws_card_equal_cpu": len(draws["cpu"]),
            "population_card_vs_cpu_max_ulps": pop_ulps,
            "profile": prof, "population": strat.population,
            "generations": strat.generations})
    return res


def phase_serve6b(tree, tok) -> dict:
    """Slice 6b on the card (see the module docstring, phase 22)."""
    import dataclasses as dc
    from distributedtraining_tpu_torch.models import gpt2
    cfg = gpt2.PRESETS["gpt2-124m"]
    prompts, lanes = _s6b_traffic(cfg.vocab_size)
    res: dict = {"model": "gpt2-124m", "dtype": cfg.dtype,
                 "prompts": [len(p) for p in prompts], "new_tokens": S6B_NEW}
    t0 = time.perf_counter()
    res["f32"] = _disagg_parity(dc.replace(cfg, dtype="float32"),
                                _sharpened(tree), prompts, lanes, DEV)
    res["f32"]["s"] = time.perf_counter() - t0
    log("serve6b f32:", json.dumps(res["f32"]))
    t0 = time.perf_counter()
    cli = _s6b_cli(tree, prompts, lanes)
    threads, rcs, work = (cli.pop(k) for k in ("threads", "rcs", "work"))
    cli["s"] = time.perf_counter() - t0
    res["cli"] = cli
    log("serve6b cli:", json.dumps(cli))
    # the workers end on their own once idle (2 x --swap-poll): the load
    # points run meanwhile, on engines of their own
    t0 = time.perf_counter()
    res["load"] = _s6b_load(tree)
    res["load"]["s"] = time.perf_counter() - t0
    log("serve6b load:", json.dumps(res["load"]))
    for name, th in threads.items():
        th.join(120)
        check(not th.is_alive() and rcs.get(name) == 0,
              f"the {name} CLI did not exit 0: {rcs}")
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    res["genetic"] = _s6b_genetic(tree, tok)
    res["genetic"]["s"] = time.perf_counter() - t0
    log("serve6b genetic:", json.dumps(res["genetic"]))
    return res


# ---------------------------------------------------------------------------
# 23. parallel: the miner on a dp x fsdp x tp mesh over torch.distributed
# ---------------------------------------------------------------------------

PAR_SHARDED_REPLACES = "distributedtraining_tpu/ops/pallas_ce.py:381"
PAR_SHARDED_SOURCE = ("distributedtraining_tpu_torch/ops/fused_ce.py "
                      "(fused_ce_loss_sharded) around "
                      "distributedtraining_tpu_torch/csrc/fused_ce.cu")
# the sharded CE's rows as (B, T) of the hidden states: the training
# shape's 8184, and 1023, which tp does not divide (padding at mask 0)
PAR_ROWS, PAR_RAGGED_ROWS = (8, 1023), (1, 1023)
PAR_MODEL = "gpt2-124m"
PAR_V, PAR_E = 50304, 768
PAR_CLI_B, PAR_CLI_T, PAR_CLI_STEPS = 8, 128, 3
# (d): timed bf16 engine steps and the f32 parity (global batches)
PAR_STEP_B, PAR_STEP_T, PAR_STEP_REPS = 4, 256, 3
PAR_F32_B, PAR_F32_T, PAR_F32_STEPS = 4, 128, 3
PAR_TIMEOUT_S = 300
# (b)'s limits on each output's error over its largest reference value:
# bf16 CE_TOL's; f32 1e-4, where the sound readings are the summation
# order of the kernels at other row counts (to 4.7e-6 at world 2 on one
# card, 1.32e-5 for dh at dp2 x tp2 over NCCL on four), and a planted
# halved dW shard reads 0.5 and a zeroed dh 1
PAR_CE_TOL = {"float32": 1e-4, "bfloat16": CE_TOL["bfloat16"]}


def _par_world_spec(n: int) -> dict:
    """What a world of ``n`` ranks runs: (b) the sharded CE's meshes,
    the meshes whose collectives are timed, the engine's meshes and (c)
    the miner CLI's mesh flags. n 2 is phase 23 (every axis alone); a
    world of more cards mixes axes."""
    if n == 2:
        ce = {"dp2": {"dp": 2}, "fsdp2": {"fsdp": 2}, "tp2": {"tp": 2},
              "tp2_ragged": {"tp": 2}}
        engine = {"fsdp2": {"fsdp": 2}, "tp2": {"tp": 2}}
        cli = {"fsdp2": ["--fsdp", "2"], "tp2": ["--tp", "2"]}
    else:
        h = n // 2
        ce = {f"dp{h}xtp2": {"dp": h, "tp": 2},
              f"fsdp{h}xtp2": {"fsdp": h, "tp": 2},
              f"fsdp{n}": {"fsdp": n}, f"tp{n}_ragged": {"tp": n}}
        engine = {f"fsdp{n}": {"fsdp": n}, f"fsdp{h}xtp2": {"fsdp": h,
                                                          "tp": 2},
                  f"tp{n}": {"tp": n}}
        if n == 4:    # phase 25's sp beside another axis, both routes
            engine.update(sp2xtp2={"sp": 2, "tp": 2},
                          dp2xsp2={"dp": 2, "sp": 2},
                          dp2xsp2_ring={"dp": 2, "sp": 2, "impl": "ring"})
        cli = {f"fsdp{h}xtp2": ["--fsdp", str(h), "--tp", "2"],
               f"dp{n}": ["--dp", "0"]}
    return {"world": n, "ce": ce, "engine": engine,
            "collectives": {"fsdp": {"fsdp": n}, "tp": {"tp": n}},
            "cli": cli}


def _par_mesh_kw(kw: dict) -> dict:
    """An engine spec's mesh axes (its ``impl``, the attention route of
    the model, left out)."""
    return {k: v for k, v in kw.items() if k != "impl"}


def _par_ce_case(B, T, dtype, seed, dev):
    """hidden ``[B, T, E]`` in ``dtype``, the f32 head (the ``wte``
    param), int32 labels and a loss mask (10% zeros), drawn on the host
    from ``seed`` (the same values in every process)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn((B, T, PAR_E), generator=gen).to(dev, dtype)
    w = (torch.randn((PAR_V, PAR_E), generator=gen) * 0.02).to(dev)
    y = torch.randint(0, PAR_V, (B, T), generator=gen).to(dev, torch.int32)
    m = (torch.rand((B, T), generator=gen) > 0.1).float().to(dev)
    return h, w, y, m


def _par_sync() -> None:
    import torch
    torch.cuda.synchronize()


def _par_world1(dev, flat_tree) -> dict:
    """(a): on a world of 1 over NCCL, ``fused_ce_loss_sharded`` at the
    training shape equals ``fused_ce_loss`` bit for bit (value, dh, dW)
    and launches one forward, one dh and one dW; then the f32 losses and
    the timed bf16 steps of the mesh engine on that world."""
    import torch
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.parallel import (Mesh, MeshConfig,
                                                        multihost)
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=dev,
                         backend="nccl", timeout_s=PAR_TIMEOUT_S)
    out = {}
    try:
        import torch.distributed as dist
        out["backend"] = dist.get_backend()
        mesh = Mesh(MeshConfig())
        for dt in (torch.bfloat16, torch.float32):
            h, w, y, m = _par_ce_case(*PAR_ROWS, dt, SEED, dev)
            hs, ws = (h.clone().requires_grad_(), w.clone().requires_grad_())
            _zero_counts()
            loss_s, count_s = fused_ce.fused_ce_loss_sharded(hs, ws, y, m,
                                                             mesh=mesh)
            loss_s.backward()
            _par_sync()
            launches = dict(fused_ce.launches)
            h1, w1 = h.clone().requires_grad_(), w.clone().requires_grad_()
            loss_1, count_1 = fused_ce.fused_ce_loss(h1, w1, y, m)
            loss_1.backward()
            name = str(dt).split(".")[1]
            check(launches == {"fused_ce_fwd": 1, "fused_ce_bwd_dh": 1,
                               "fused_ce_bwd_dw": 1},
                  f"world-1 sharded CE {name}: launches {launches}")
            same = {"loss": torch.equal(loss_s, loss_1),
                    "count": torch.equal(count_s, count_1),
                    "dh": torch.equal(hs.grad, h1.grad),
                    "dw": torch.equal(ws.grad, w1.grad)}
            check(all(same.values()), f"world-1 sharded CE {name} is not "
                                      f"bit-equal to fused_ce_loss: {same}")
            out[name] = {"bit_equal": same, "launches": launches,
                         "loss": float(loss_1)}
            del h, w, hs, ws, h1, w1
        f32 = dataclasses.replace(gpt2.PRESETS[PAR_MODEL], dtype="float32")
        out["f32_losses"] = _par_engine_losses(f32, flat_tree,
                                               _par_f32_batches(), mesh, dev)
        out.update(_par_engine_step(gpt2.PRESETS[PAR_MODEL], flat_tree,
                                    mesh, dev, profile=False))
    finally:
        multihost.shutdown()
    return out


def _par_kernel_timing() -> dict:
    """The sharded CE's kernels at one rank's shape on world 2 (half of
    N 8184: N 4092, V 50304, E 768, bf16): forward + backward entry, the
    plain versions, one library path (cuBLAS GEMM + F.cross_entropy and
    its backward), and the least time of the same work."""
    import torch
    from distributedtraining_tpu_torch.ops import fused_ce
    n = PAR_ROWS[0] * PAR_ROWS[1] // 2
    h, w, y, g = _ce_inputs(n, PAR_V, PAR_E, torch.bfloat16, SEED + 23)
    loss, m, s = fused_ce.fused_ce_fwd(h, w, y)
    fwd = _time_ms(lambda: fused_ce.fused_ce_fwd(h, w, y))
    bwd = _time_ms(lambda: fused_ce.fused_ce_bwd(h, w, y, m, s, g))
    plain = (_time_ms(lambda: fused_ce.fused_ce_fwd_reference(h, w, y),
                      reps=5, warm=1)
             + _time_ms(lambda: _ce_plain_bwd(h, w, y, m, s, g,
                                              torch.bfloat16),
                        reps=5, warm=1))
    hh, ww = h.detach().requires_grad_(), w.detach().requires_grad_()

    def library():
        out = torch.nn.functional.cross_entropy(
            (hh @ ww.T).float(), y.long(), reduction="none")
        torch.autograd.grad(out, (hh, ww), g)

    lib = _time_ms(library)
    # inputs read once (h, the head, labels, the upstream gradient),
    # outputs written once (loss, m, s, dh, f32 dW); 2 N V E operations
    # for the forward, 6 for the backward (z again, dh and dW)
    nbytes = (n * PAR_E * 2 + PAR_V * PAR_E * 2 + 2 * n * 4 + 3 * n * 4
              + n * PAR_E * 2 + PAR_V * PAR_E * 4)
    ops = 8 * n * PAR_V * PAR_E
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_BF16_FLOPS * 1e3
    del h, w, hh, ww
    torch.cuda.empty_cache()
    return {"N": n, "V": PAR_V, "E": PAR_E, "dtype": "bfloat16",
            "fwd_ms": fwd, "bwd_ms": bwd, "ms": fwd + bwd, "plain_ms": plain,
            "library_ms": lib, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _par_engine_losses(model_cfg, tree, batches, mesh, dev) -> list:
    """Losses of ``len(batches)`` fused-loss steps from ``tree`` (each
    rank fed its rows and positions of the global batches: id arrays,
    or dicts of a packed batch's arrays)."""
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.parallel import batch_rows
    model, _ = gpt2.make_model(model_cfg)
    eng = TrainEngine(model, fused_loss=True, mesh=mesh, device=dev)
    state = eng.init_state(tree)
    losses = []
    for ids in batches:
        b = ids if isinstance(ids, dict) else {"input_ids": ids}
        if mesh is not None and mesh.world_size > 1:
            b = batch_rows(b, mesh)
        state, m = eng.train_step(state, eng.place_batch(b))
        losses.append(float(m["loss"]))
    return losses


def _par_coll_since(before: dict) -> dict:
    """``{op: [calls, bytes]}`` of the collectives since the snapshot
    ``before`` of ``collectives.counts`` (every backend and route)."""
    from distributedtraining_tpu_torch.parallel import collectives
    out: dict = {}
    for key, c in collectives.counts.items():
        b = before.get(key, {"calls": 0, "bytes": 0})
        if c["calls"] != b["calls"]:
            o = out.setdefault(key[0], [0, 0])
            o[0] += c["calls"] - b["calls"]
            o[1] += c["bytes"] - b["bytes"]
    return out


def _par_coll_snapshot() -> dict:
    from distributedtraining_tpu_torch.parallel import collectives
    return {k: dict(v) for k, v in collectives.counts.items()}


def _par_tp_step_want(cfg, rows: int) -> dict:
    """``{op: [calls, bytes]}`` of one fused-loss step without a clip on a
    tp-only mesh whose blocks split their heads, a rank's ``rows``
    tokens: tp all-gathers ``wte`` (the embedding and the CE's head) and
    each block's ``c_attn`` kernel and bias, the kernel again for the
    backward (f32 storage, the gathered buffer's bytes); four all-reduces
    a block of its ``[rows, E]`` activations in the compute dtype (two
    forward, two backward), the CE's dh and its two f32 totals; each
    ``c_attn`` leaf's gradient and the head's reduce-scattered (f32, the
    full buffer). No gather of ``c_proj``, ``c_fc`` or ``mlp_proj``."""
    import torch
    L, E, V = cfg.n_layer, cfg.n_embd, cfg.padded_vocab
    act = torch.empty((), dtype=cfg.compute_dtype()).element_size()
    qkv = 3 * E * E + 3 * E
    return {"all_gather": [3 * L + 2, 4 * (2 * V * E + L * (qkv + 3 * E * E))],
            "all_reduce": [4 * L + 3, act * (4 * L + 1) * rows * E + 8],
            "reduce_scatter": [2 * L + 1, 4 * (L * qkv + V * E)]}


def _par_kernel_ms(fn) -> dict | None:
    """Device ms of one call of ``fn`` by torch.profiler: the total, the
    copies (``Memcpy``: under gloo, the staging through host memory), the
    kernels and the eight largest names; None where the profiler saw no
    device time (recorded as not measured; nothing else rests on it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by[evt.name] = by.get(evt.name, 0.0) + \
                evt.time_range.elapsed_us() / 1e3
    if not by:
        return None
    copies = sum(v for k, v in by.items() if k.startswith("Memcpy"))
    top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    return {"total": sum(by.values()), "memcpy": copies,
            "kernels": sum(by.values()) - copies, "names": len(by),
            "top": {k[:72]: v for k, v in top}}


def _par_engine_step(model_cfg, tree, mesh, dev, profile: bool = True,
                     batch: dict | None = None) -> dict:
    """Median host ms of a bf16 fused-loss step (synchronised) at global
    B ``PAR_STEP_B``, T ``PAR_STEP_T`` (or on the global ``batch``: this
    rank's rows and positions of it), after one untimed step; this
    process's peak of allocated card memory above what it held before
    the engine's state (the state, a step's gathered parameters,
    activations and gradients); the launches, block routes
    (``sharding.counts``) and collectives of each of those steps; then,
    with ``profile`` (in a child process: the main one leaves the
    profiler to the phases that time kernels by it), one more step's
    device ms by kernel."""
    import numpy as np
    import torch
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.parallel import batch_rows, sharding
    model, _ = gpt2.make_model(model_cfg)
    eng = TrainEngine(model, fused_loss=True, mesh=mesh, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # what earlier work holds
    state = eng.init_state(tree)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, model_cfg.vocab_size,
                       (PAR_STEP_B, PAR_STEP_T)).astype(np.int32)
    b = {"input_ids": ids} if batch is None else batch
    if mesh is not None and mesh.world_size > 1:
        b = batch_rows(b, mesh)
    b = eng.place_batch(b)
    times, colls = [], []
    _zero_counts()
    sharding.reset_counts()
    for i in range(PAR_STEP_REPS + 1):
        before = _par_coll_snapshot()
        _par_sync()
        t0 = time.perf_counter()
        state, _ = eng.train_step(state, b)
        _par_sync()
        colls.append(_par_coll_since(before))
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    out = {"step_ms": statistics.median(times),
           "step_peak_bytes": torch.cuda.max_memory_allocated() - held,
           "step_rows": int(b["input_ids"].numel()),
           "step_launches": {**fa.launches, **fused_ce.launches},
           "step_routes": dict(sharding.counts),
           "step_collectives": colls,
           # an engine from before the tp blocks has no route
           "tp_route": getattr(eng, "tp_route", None)}
    if profile:
        out["step_device_ms"] = _par_kernel_ms(
            lambda: eng.train_step(state, b))
    return out


def _par_f32_batches() -> list:
    import numpy as np
    from distributedtraining_tpu_torch.models import gpt2
    rng = np.random.default_rng(SEED + 1)
    v = gpt2.PRESETS[PAR_MODEL].vocab_size
    return [rng.integers(0, v, (PAR_F32_B, PAR_F32_T)).astype(np.int32)
            for _ in range(PAR_F32_STEPS)]


# -- world 2: one process a rank, both on the one card, over gloo ----------

def _par_worker_ce(dev, meshes: dict) -> dict:
    """(b) on this rank: each mesh and dtype, this rank's rows and head
    shard through ``fused_ce_loss_sharded``, held against
    ``fused_ce_loss`` over every row on the same card (world 1's
    result): the loss, this rank's rows of dh and its shard of dW (summed
    over dp, as the engine sums every gradient)."""
    import torch
    import torch.distributed as dist
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.parallel import (
        Mesh, MeshConfig, batch_rows, collectives, shard_params)
    from distributedtraining_tpu_torch.parallel.sharding import shard_slices
    out = {}
    for name, kw in meshes.items():
        mesh = Mesh(MeshConfig(**kw))
        B, T = PAR_RAGGED_ROWS if name.endswith("_ragged") else PAR_ROWS
        for dt in (torch.bfloat16, torch.float32):
            dtn = str(dt).split(".")[1]
            h, w, y, m = _par_ce_case(B, T, dt, SEED + 5, dev)
            hr, wr = h.clone().requires_grad_(), w.clone().requires_grad_()
            lr, _ = fused_ce.fused_ce_loss(hr, wr, y, m)
            lr.backward()
            rows = batch_rows({"h": h, "y": y, "m": m}, mesh)
            hs = rows["h"].clone().requires_grad_()
            ws = shard_params({"wte": w}, mesh, device=dev)["wte"]
            ws.requires_grad_()
            _zero_counts()
            _par_sync()
            dist.barrier()        # both ranks start the timed call together
            t0 = time.perf_counter()
            loss, count = fused_ce.fused_ce_loss_sharded(
                hs, ws, rows["y"], rows["m"], mesh=mesh)
            loss.backward()
            _par_sync()
            ms = (time.perf_counter() - t0) * 1e3
            launches = dict(fused_ce.launches)
            dw = collectives.all_reduce_(ws.grad, mesh, ("dp",))
            i = mesh.index(("dp", "fsdp"))
            per = B // mesh.size(("dp", "fsdp"))
            sl = shard_slices("wte", tuple(w.shape), ("tp", "fsdp"),
                              mesh.shape, mesh.coords)
            ref_dh, ref_dw = hr.grad[i * per:(i + 1) * per], wr.grad[sl]
            # PAR_CE_TOL of the largest reference value in both dtypes
            # (_ce_limit_errors' bf16 rule: the gradients are far below
            # 1), with planted faults that the limit must reject
            errs = _ce_limit_errors({
                "loss": (loss.detach().reshape(1), lr.detach().reshape(1)),
                "dh": (hs.grad, ref_dh), "dw": (dw, ref_dw)}, "bfloat16")
            planted = _ce_limit_errors({
                "dh_zeroed": (torch.zeros_like(ref_dh), ref_dh),
                "dw_halved": (dw * 0.5, ref_dw)}, "bfloat16")
            out[f"{name}_{dtn}"] = {
                "rows": [B, T], "coords": mesh.coords, "host_ms": ms,
                "count": float(count), "launches": launches,
                "max_abs": {k: d for k, (d, _) in errs.items()},
                "err": {k: e for k, (_, e) in errs.items()},
                "planted_err": {k: e for k, (_, e) in planted.items()}}
            del h, w, hr, wr, hs, ws, dw
    return out


def _par_worker_collectives(dev, meshes: dict) -> dict:
    """Host ms (synchronised, median of 3 after one) and bytes of each
    collective of the sharded CE at its training-shape buffers, the
    world along fsdp alone and along tp alone: the head's all-gather and
    dW's reduce-scatter, dh's all-reduce over tp, the loss totals'
    all-reduce."""
    import torch
    from distributedtraining_tpu_torch.parallel import (Mesh, MeshConfig,
                                                        collectives)
    rows = PAR_ROWS[0] * PAR_ROWS[1]
    f32, bf = torch.float32, torch.bfloat16
    meshes = {k: Mesh(MeshConfig(**kw)) for k, kw in meshes.items()}
    k = meshes["fsdp"].world_size

    def zeros(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cases = {
        f"all_gather_head_fsdp{k}": ("fsdp", lambda m: collectives
                                     ._raw_all_gather(
                                         zeros((PAR_V, PAR_E // k)),
                                         m.group("fsdp"), k, 1)),
        f"all_gather_head_tp{k}": ("tp", lambda m: collectives
                                   ._raw_all_gather(
                                       zeros((PAR_V // k, PAR_E)),
                                       m.group("tp"), k, 0)),
        f"reduce_scatter_dw_fsdp{k}": ("fsdp", lambda m: collectives
                                       ._raw_reduce_scatter(
                                           zeros((PAR_V, PAR_E)),
                                           m.group("fsdp"), k, 1)),
        f"reduce_scatter_dw_tp{k}": ("tp", lambda m: collectives
                                     ._raw_reduce_scatter(
                                         zeros((PAR_V, PAR_E)),
                                         m.group("tp"), k, 0)),
        f"all_reduce_dh_tp{k}": ("tp", lambda m: collectives
                                 ._raw_all_reduce(zeros((rows, PAR_E), bf),
                                                  m.group("tp"))),
        f"all_reduce_totals_tp{k}": ("tp", lambda m: collectives
                                     ._raw_all_reduce(zeros(()),
                                                      m.group("tp"))),
    }
    out = {}
    for name, (mesh_name, fn) in cases.items():
        mesh = meshes[mesh_name]
        before = {k: dict(v) for k, v in collectives.counts.items()}
        times = []
        for i in range(4):
            _par_sync()
            t0 = time.perf_counter()
            fn(mesh)
            _par_sync()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        after = collectives.counts
        key = next(k for k in after
                   if after[k]["calls"] != before.get(k, {}).get("calls", 0))
        calls = after[key]["calls"] - before.get(key, {}).get("calls", 0)
        out[name] = {"ms": statistics.median(times), "op": key[0],
                     "backend": key[1], "route": key[2],
                     "bytes": (after[key]["bytes"] - before.get(
                         key, {}).get("bytes", 0)) // calls}
    return out


def _par_worker_cli(dev, flags: list, work: str, *, b: int = PAR_CLI_B,
                    t: int = PAR_CLI_T, steps: int = PAR_CLI_STEPS) -> dict:
    """(c) on this rank: ``neurons.miner.main`` on this world with the
    mesh ``flags`` (global batch ``b``, ``t`` positions, ``steps``
    steps); launch counts and block routes set to 0 just before
    and read just after, the collectives of each train step; this rank's
    shards right after the pull against the base's slices."""
    import torch
    from distributedtraining_tpu_torch import delta
    from distributedtraining_tpu_torch.engine import train as ttrain
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.neurons import miner as miner_cli
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.parallel import sharding, shard_params
    base = delta.flatten_tree(gpt2.init_params_numpy(
        gpt2.PRESETS[PAR_MODEL], SEED))
    seen = {}
    bootstrap = ttrain.MinerLoop.bootstrap

    def watched(loop, *a, **kw):
        bootstrap(loop, *a, **kw)
        want = shard_params(base, loop.engine.mesh, specs=loop.engine.specs,
                            device=dev)
        seen.update(loop=loop, boot_bit_equal=all(
            torch.equal(loop.state.params[k].detach(), want[k])
            for k in want), base_revision=loop._base_revision)

    step = ttrain.TrainEngine.train_step
    colls = []

    def counted(eng, *a, **kw):
        before = _par_coll_snapshot()
        out = step(eng, *a, **kw)
        colls.append(_par_coll_since(before))
        return out

    argv = (README_MINER_FLAGS + flags + [
        "--work-dir", work, "--batch-size", str(b), "--seq-len", str(t),
        "--max-steps", str(steps)])
    ttrain.MinerLoop.bootstrap = watched
    ttrain.TrainEngine.train_step = counted
    try:
        _zero_counts()
        sharding.reset_counts()
        t0 = time.perf_counter()
        rc = miner_cli.main(argv)
        _par_sync()
        secs = time.perf_counter() - t0
        launches = {**fa.launches, **fused_ce.launches}
        routes = dict(sharding.counts)
    finally:
        ttrain.MinerLoop.bootstrap = bootstrap
        ttrain.TrainEngine.train_step = step
    loop = seen["loop"]
    return {"argv": argv, "rc": rc, "s": secs, "steps": loop.report.steps,
            "routes": routes, "step_collectives": colls,
            "tp_route": loop.engine.tp_route,
            "pushes": loop.report.pushes,
            "pushes_failed": loop.report.pushes_failed,
            "launches": launches, "boot_bit_equal": seen["boot_bit_equal"],
            "base_revision": seen["base_revision"],
            "mesh": loop.engine.mesh.shape,
            "coords": loop.engine.mesh.coords}


def parallel_worker(rank: int, port: int, tmp: str) -> int:
    """One rank of a world of ``_par_world_spec`` (``--parallel-worker``):
    (b), the collectives' times, the f32 parity and timed steps of the
    fsdp engine, then (c) (or (b) alone, when the spec says ``ce_only``);
    its results in ``tmp/out_<rank>.json``. Any failed collective, kernel
    or check raises, and the process exits non-zero."""
    import torch
    from distributedtraining_tpu_torch.delta import flatten_tree
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.parallel import (Mesh, MeshConfig,
                                                        collectives,
                                                        multihost)
    sys.path.insert(0, ROOT)
    with open(os.path.join(tmp, "spec.json")) as f:
        spec = json.load(f)
    dev = DEV
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = spec["world"]
    multihost.initialize(f"127.0.0.1:{port}", world["world"], rank,
                         device=dev, backend=spec["backend"],
                         timeout_s=PAR_TIMEOUT_S)
    import torch.distributed as dist
    out = {"rank": rank, "backend": dist.get_backend(),
           "device": torch.cuda.current_device()}
    try:
        collectives.reset_counts()
        out["ce"] = _par_worker_ce(dev, world["ce"])
        if spec.get("ce_only"):
            return _par_worker_done(tmp, rank, out)
        out["collectives"] = _par_worker_collectives(dev,
                                                     world["collectives"])
        tree = flatten_tree(gpt2.init_params_numpy(
            gpt2.PRESETS[PAR_MODEL], SEED))
        f32 = dataclasses.replace(gpt2.PRESETS[PAR_MODEL], dtype="float32")
        out["engine"] = {}
        for name, kw in world["engine"].items():
            mesh = Mesh(MeshConfig(**_par_mesh_kw(kw)))
            impl = {"attention_impl": kw.get("impl", "flash")}
            out["engine"][name] = {
                "f32_losses": _par_engine_losses(
                    dataclasses.replace(f32, **impl), tree,
                    _par_f32_batches(), mesh, dev),
                **_par_engine_step(dataclasses.replace(
                    gpt2.PRESETS[PAR_MODEL], **impl), tree, mesh, dev)}
        del tree
        out["cli"] = {name: _par_worker_cli(dev, world["cli"][name], work)
                      for name, work in spec["cli_work"].items()}
        out["collective_counts"] = [
            {"op": k[0], "backend": k[1], "route": k[2], **v}
            for k, v in sorted(collectives.counts.items())]
    finally:
        multihost.shutdown()
    return _par_worker_done(tmp, rank, out)


def _par_worker_done(tmp: str, rank: int, out: dict) -> int:
    with open(os.path.join(tmp, f"out_{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _par_score(tree, tok, work: str) -> dict:
    """The pushed delta of a world-2 CLI run: finite, and the held-out
    score of base + delta (base loss - trained loss, the validator's
    rule) on the card, one device."""
    import math
    import numpy as np
    from distributedtraining_tpu_torch import serialization as ser
    from distributedtraining_tpu_torch.engine.train import (TrainEngine,
                                                            _wire_template)
    from distributedtraining_tpu_torch.models import gpt2
    model, _ = gpt2.make_model(gpt2.PRESETS[PAR_MODEL])
    deltas = os.path.join(work, "artifacts", "deltas")
    files = sorted(os.listdir(deltas))
    check(files == ["hotkey_0.meta.json", "hotkey_0.msgpack"],
          f"world-2 CLI: the deltas on the transport are {files}: one "
          f"artifact and its rider, from the coordinator")
    with open(os.path.join(deltas, "hotkey_0.msgpack"), "rb") as f:
        d = ser.from_msgpack(f.read(), _wire_template(model))
    check(all(bool(np.isfinite(np.asarray(v)).all()) for v in _leaves(d)),
          "world-2 CLI: the pushed delta has non-finite values")
    eng = TrainEngine(model, fused_loss=True, device="cuda")
    held = _batches(tok, split="test", batch_size=PAR_CLI_B,
                    seq_len=PAR_CLI_T, n=2)
    base = gpt2.params_from_numpy(tree, device="cuda")
    dstate = gpt2.params_from_numpy(d, device="cuda")
    base_loss, _ = eng.evaluate(base, held)
    trained_loss, _ = eng.evaluate({k: base[k] + dstate[k] for k in base},
                                   held)
    score = base_loss - trained_loss
    check(math.isfinite(score) and score > 0,
          f"world-2 CLI: held-out score of base + delta {score} is not > 0")
    return {"base_loss": base_loss, "trained_loss": trained_loss,
            "score": score}


def _par_spawn(n: int, backend: str, spec: dict, tmp: str, what: str,
               mode: str = "--parallel-worker") -> list:
    """Run ``n`` ranks (``mode``: ``--parallel-worker`` or a phase 24
    child) on ``spec`` (written to ``tmp/spec.json``): over gloo every
    rank on this card, over NCCL rank r on card r. Any rank that exits
    non-zero fails the phase (its log's tail logged first). Returns each
    rank's ``out_<rank>.json``."""
    with open(os.path.join(tmp, "spec.json"), "w") as f:
        json.dump(spec, f)
    port = _free_port()
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(n)]
    env = {**os.environ, "DT_DIST_BACKEND": backend}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode,
         str(r), str(port), tmp], stdout=logs[r],
        stderr=subprocess.STDOUT, cwd=ROOT,
        env={**env, **({"LOCAL_RANK": str(r)} if backend == "nccl"
                       else {})}) for r in range(n)]
    try:
        rcs = [p.wait(timeout=PAR_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        for f in logs:
            f.close()
    if any(rcs):
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                log(f"--- rank {r} (exit {rcs[r]}):\n" + f.read()[-6000:])
    check(not any(rcs), f"{what}: ranks exited {rcs}")
    outs = []
    for r in range(n):
        with open(os.path.join(tmp, f"out_{r}.json")) as f:
            outs.append(json.load(f))
    return outs


def _par_check_ce(what: str, outs: list) -> dict:
    """(b) within PAR_CE_TOL of world 1's largest value, every rank,
    mesh, dtype and output; the planted faults outside it; 1 / 1 / 1
    launches a rank. Every reading is logged before the first check."""
    log(f"{what} sharded CE errors:", json.dumps(
        {key: [{"err": o["ce"][key]["err"],
                "planted_err": o["ce"][key]["planted_err"]}
               for o in outs] for key in outs[0]["ce"]}))
    ce = {}
    for key in outs[0]["ce"]:
        per = [o["ce"][key] for o in outs]
        tol = PAR_CE_TOL["float32" if key.endswith("float32")
                         else "bfloat16"]
        for r, c in enumerate(per):
            for out_name, err in c["err"].items():
                check(err <= tol, f"{what} sharded CE {key} rank {r}: "
                                  f"{out_name} error {err} > {tol}")
            for out_name, err in c["planted_err"].items():
                check(err > tol, f"{what} sharded CE {key} rank {r}: "
                                 f"planted {out_name} error {err} "
                                 f"passes the limit {tol}")
            check(c["launches"] == {"fused_ce_fwd": 1,
                                    "fused_ce_bwd_dh": 1,
                                    "fused_ce_bwd_dw": 1},
                  f"{what} sharded CE {key} rank {r}: launches "
                  f"{c['launches']}")
        ce[key] = {"max_err": max(e for c in per for e in c["err"].values()),
                   "err": {o: max(c["err"][o] for c in per)
                           for o in per[0]["err"]},
                   "planted_err": {o: min(c["planted_err"][o] for c in per)
                                   for o in per[0]["planted_err"]},
                   "max_abs": max(d for c in per
                                  for d in c["max_abs"].values()),
                   "host_ms": [c["host_ms"] for c in per],
                   "tol": tol}
    return ce


def _par_run_ce_world(n: int, backend: str) -> dict:
    """(b) alone on the sharded-CE meshes of ``_par_world_spec(n)``: a
    world of ``n`` child processes, checked by ``_par_check_ce``."""
    import tempfile
    what = f"world {n} ({backend}, CE only)"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = _par_spawn(n, backend, {"backend": backend,
                                       "world": _par_world_spec(n),
                                       "cli_work": {}, "ce_only": True},
                          tmp, what)
    return {"backend": [o["backend"] for o in outs],
            "devices": [o["device"] for o in outs],
            "ce": _par_check_ce(what, outs), "s": time.perf_counter() - t0}


def _par_run_world(n: int, backend: str, tree, tok, f32_world1: list
                   ) -> dict:
    """A world of ``n`` child processes (``--parallel-worker``): over
    gloo, every rank on this card; over NCCL, rank r on card r. Checks
    (b) against ``PAR_CE_TOL`` of the max, (c) and the f32 losses against world 1's
    (1e-4 relative); any failed rank fails the phase."""
    import tempfile
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    world = _par_world_spec(n)
    what = f"world {n} ({backend})"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cli_work = {}
        for name in world["cli"]:
            work = os.path.join(tmp, f"cli_{name}")
            LocalFSTransport(os.path.join(work, "artifacts")).publish_base(
                tree)
            cli_work[name] = work
        outs = _par_spawn(n, backend, {"backend": backend, "world": world,
                                       "cli_work": cli_work}, tmp, what)
        res = {"backend": [o["backend"] for o in outs],
               "devices": [o["device"] for o in outs],
               "ce": _par_check_ce(what, outs)}
        # (c) the CLI runs: coordinator-only publishing, exact counts,
        # shards after the pull, the delta's score
        cli = {}
        for name, work in cli_work.items():
            runs = [o["cli"][name] for o in outs]
            for r, run in enumerate(runs):
                check(run["rc"] == 0 and run["steps"] == PAR_CLI_STEPS,
                      f"{what} CLI {name} rank {r}: rc {run['rc']}, steps "
                      f"{run['steps']}")
                check(run["boot_bit_equal"], f"{what} CLI {name} rank {r}: "
                      f"shards after the pull differ from the base's slices")
                _check_launches(f"{what} CLI {name} rank {r}",
                                run["launches"], _train_want(
                                    gpt2.PRESETS[PAR_MODEL], run["steps"],
                                    fused=True))
                _par_check_tp(f"{what} CLI {name} rank {r}", run["mesh"],
                              run["tp_route"], run["routes"],
                              run["step_collectives"], PAR_CLI_T * (
                                  PAR_CLI_B // (run["mesh"]["dp"]
                                                * run["mesh"]["fsdp"])))
            check(runs[0]["pushes"] >= 1 and runs[0]["pushes_failed"] == 0
                  and all(x["pushes"] == 0 for x in runs[1:]),
                  f"{what} CLI {name}: pushes {[x['pushes'] for x in runs]}"
                  f" (only the coordinator publishes)")
            cli[name] = {"argv": runs[0]["argv"],
                         "s": [x["s"] for x in runs],
                         "routes": runs[0]["routes"],
                         "step_collectives": runs[0]["step_collectives"][-1],
                         "pushes": [x["pushes"] for x in runs],
                         "launches": [x["launches"] for x in runs],
                         "mesh": runs[0]["mesh"],
                         "coords": [x["coords"] for x in runs],
                         **_par_score(tree, tok, work)}
        res["cli"] = cli
    engines = {}
    for name, kw in world["engine"].items():
        runs = [o["engine"][name] for o in outs]
        for r, run in enumerate(runs):
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(run["f32_losses"], f32_world1))
            check(rel <= 1e-4, f"{what} f32 {name} rank {r} losses "
                               f"{run['f32_losses']} vs world 1 "
                               f"{f32_world1}: {rel} relative")
            steps = len(run["step_collectives"])
            want = _train_want(gpt2.PRESETS[PAR_MODEL], steps, fused=True)
            if kw.get("impl") == "ring":      # the ring runs no flash kernel
                want = {k: (0 if k.startswith("flash") else v)
                        for k, v in want.items()}
            _check_launches(f"{what} engine {name} rank {r}",
                            run["step_launches"], want)
            _par_check_tp(f"{what} engine {name} rank {r}",
                          {"dp": 1, "fsdp": 1, "tp": 1, **kw},
                          run["tp_route"], run["step_routes"],
                          run["step_collectives"], run["step_rows"])
        engines[name] = {
            "mesh": kw, "tp_route": runs[0]["tp_route"],
            "f32_losses": [x["f32_losses"] for x in runs],
            "step_ms": [x["step_ms"] for x in runs],
            "step_peak_bytes": [x["step_peak_bytes"] for x in runs],
            "step_collectives": runs[0]["step_collectives"][-1],
            "step_routes": runs[0]["step_routes"],
            "step_device_ms": [x.get("step_device_ms") for x in runs]}
    res.update(engine=engines, collectives=outs[0]["collectives"],
               collective_counts=[o["collective_counts"] for o in outs],
               s=time.perf_counter() - t0)
    return res


def _par_check_tp(what: str, mesh: dict, route, routes: dict, colls: list,
                  rows: int) -> None:
    """The blocks' route on ``mesh`` by the shape rule, every block of
    every step counted on it; on a tp-only mesh whose blocks split their
    heads, each step's collectives exactly ``_par_tp_step_want``'s."""
    from distributedtraining_tpu_torch.models import gpt2
    cfg = gpt2.PRESETS[PAR_MODEL]
    tp = mesh.get("tp", 1)
    want_route = (None if tp == 1 else
                  "head_split" if cfg.n_head % tp == 0 else "gathered_attn")
    check(route == want_route, f"{what}: route {route} != {want_route}")
    blocks = cfg.n_layer * len(colls)
    want = {f"tp_{r}_blocks": blocks if r == route else 0
            for r in ("head_split", "gathered_attn")}
    got = {k: routes[k] for k in want}
    check(got == want, f"{what}: block routes {got} != {want}")
    if route == "head_split" and mesh.get("dp", 1) * mesh.get("fsdp", 1) \
            * mesh.get("sp", 1) == 1:
        want_c = _par_tp_step_want(cfg, rows)
        for i, c in enumerate(colls):
            check(c == want_c, f"{what}: step {i} collectives {c} != "
                               f"{want_c}")


def phase_parallel(tree, tok) -> dict:
    """Phase 23 (see the module docstring): (a) world 1 over NCCL in this
    process; then a world of 2 over gloo, both ranks on this card; then
    (b) alone on the four-rank meshes, four gloo ranks on this card."""
    import torch
    from distributedtraining_tpu_torch.delta import flatten_tree
    t_start = time.perf_counter()
    res = {"world1": _par_world1(DEV, flatten_tree(tree)),
           "kernel": _par_kernel_timing()}
    res["world1_s"] = time.perf_counter() - t_start
    torch.cuda.empty_cache()
    res["world2"] = _par_run_world(2, "gloo", tree, tok,
                                   res["world1"]["f32_losses"])
    res["world4_gloo_ce"] = _par_run_ce_world(4, "gloo")
    res["s"] = time.perf_counter() - t_start
    log("parallel:", json.dumps(res))
    return res


def _sharded_entry(par: dict) -> dict:
    """Phase 23's line for the sharded CE: its kernels at one rank's
    shape, the launches of the main path (rank 0 of the first world-2
    CLI run), the world-2 errors and the collectives (gloo, one card)."""
    k = par["kernel"]
    w2 = par["world2"]
    runs = w2["cli"]
    return {
        "name": "fused_ce_loss_sharded", "route": "cuda",
        "source": PAR_SHARDED_SOURCE, "replaces": PAR_SHARDED_REPLACES,
        "tpu_kernel": "distributedtraining_tpu/ops/pallas_ce.py:"
                      "fused_ce_loss_sharded (pallas_call :178, :201, :220 "
                      "under shard_map)",
        "launches": next(iter(runs.values()))["launches"][0]["fused_ce_fwd"],
        "launches_by_run": {name: [x["fused_ce_fwd"] for x in r["launches"]]
                            for name, r in runs.items()},
        "max_abs_err": max(c["max_abs"] for c in w2["ce"].values()),
        "max_limit_err": {key: c["max_err"] for key, c in w2["ce"].items()},
        "ms": k["ms"], "fwd_ms": k["fwd_ms"], "bwd_ms": k["bwd_ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        "timed_shape": f"one rank of world 2: N {k['N']}, V {k['V']}, "
                       f"E {k['E']}, {k['dtype']}",
        "collectives_ms_gloo_one_card": {
            name: c["ms"] for name, c in w2["collectives"].items()}}


# ---------------------------------------------------------------------------
# 24. the validator and the averager on a mesh
# ---------------------------------------------------------------------------

# the chain weights the averager's rounds read (phase 16's), so that the
# weighted merge's consensus is not uniform
MR_SCORES = {"hotkey_1": 0.5, "hotkey_2": 0.1, "hotkey_3": 0.15,
             "hotkey_4": 0.15, "hotkey_5": 0.3, "hotkey_6": 0.3}
MR_STALE = "an-older-base"
# the CLIs' run length: (c) checks the pod's plumbing, not the merge
MR_CLI_FLAGS = ["--eval-batches", "2", "--rounds", "1"]
MR_TIMED = ("_raw_all_reduce", "_raw_all_gather", "broadcast_")


class _Calls:
    """A transport or chain whose method calls are counted by name (a
    measuring hook of this script)."""

    def __init__(self, inner):
        self._inner = inner
        self.calls: dict = {}

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr

        def call(*a, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            return attr(*a, **kw)
        return call


def _mr_fleet(tree, tok, root: str) -> str:
    """Phase 17's submissions on a fresh root over the base ``tree``:
    three honest MinerLoop miners (--wire-v2 int8, --wire-v2 with f32
    kept values, dense v1), a dense delta whose rider names another base
    (hotkey_4), and phase 16's hostiles (hotkey_5: an index out of
    range, hotkey_6: a value over the cap). Returns the base's
    revision."""
    import torch
    from distributedtraining_tpu_torch import delta
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    t = LocalFSTransport(root)
    rev = t.publish_base(tree)
    train = _batches(tok, split="train", batch_size=MINER_B,
                     seq_len=MINER_T, n=3 * AVG_MINER_STEPS)
    for i, (h, v2, quant) in enumerate((("hotkey_1", True, "int8"),
                                        ("hotkey_2", True, "none"),
                                        ("hotkey_3", False, "int8"))):
        _honest_miner(t, h, train[i * AVG_MINER_STEPS:
                                  (i + 1) * AVG_MINER_STEPS],
                      wire_v2=v2, quant=quant)
    shapes = {k: v.shape for k, v in gpt2.make_model(
        gpt2.PRESETS["gpt2-124m"])[0].state_dict().items()}
    g = torch.Generator(device=DEV).manual_seed(SEED + 24)

    def noise(scale):
        return {k: torch.randn(s, generator=g, device=DEV) * scale
                for k, s in shapes.items()}

    t.publish_delta("hotkey_4", gpt2.params_to_numpy(noise(1e-5)))
    t.publish_delta_meta("hotkey_4", {"base_revision": MR_STALE})
    bad, _ = delta.pack_delta_v2(noise(1e-5), density=1.0 / 64.0)
    bad["leaves"]["wpe"]["idx"][0] = shapes["wpe"].numel()
    _publish_tree(t, "hotkey_5", bad, rev, "int8")
    huge, _ = delta.pack_delta_v2(noise(1e-5), density=1.0 / 64.0)
    huge["leaves"]["wte"]["scale"] = torch.tensor(1e6, device=DEV)
    _publish_tree(t, "hotkey_6", huge, rev, "int8")
    return rev


def _mr_dirs(src: str, dst: str, cli: bool = False) -> dict:
    """A world's roots as hard links of the fleet's (a publish writes a
    new file and renames it, so no world sees another's): the
    validator's, the weighted round's and the parameterized round's,
    with their chains (MR_SCORES set in the averagers'); with ``cli``,
    the two CLIs' work dirs too."""
    import shutil
    from distributedtraining_tpu_torch.chain import LocalChain
    out = {}
    for name in ("val", "weighted", "param") + (("cli_val", "cli_avg")
                                                 if cli else ()):
        work = os.path.join(dst, name)
        shutil.copytree(src, os.path.join(work, "artifacts"),
                        copy_function=os.link)
        if name in ("weighted", "param", "cli_avg"):
            LocalChain(os.path.join(work, "chain"),
                       my_hotkey="hotkey_91").set_weights(MR_SCORES)
        out[name] = work
    return out


def _mr_collective_timer():
    """Wrap the collectives' entries so that each call's wall ms, between
    two device synchronisations, adds to the returned dict (by entry);
    the second value restores them."""
    import torch
    from distributedtraining_tpu_torch.parallel import collectives as coll
    ms: dict = {}
    orig = {n: getattr(coll, n) for n in MR_TIMED}

    def wrap(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return run

    for name, fn in orig.items():
        setattr(coll, name, wrap(name, fn))
    return ms, lambda: [setattr(coll, n, f) for n, f in orig.items()]


def _mr_measured(fn) -> dict:
    """Run ``fn`` (one round) with every launch count at 0 just before
    and read just after, the peak card memory reset, the collectives
    timed and counted: ``{"out", "s", "launches", "peak_bytes",
    "collective_ms", "collectives"}``."""
    import torch
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.parallel import collectives as coll
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    coll.reset_counts()
    ms, restore = _mr_collective_timer()
    _zero_counts()
    dsc.launches = 0
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        restore()
    return {"out": out, "s": time.perf_counter() - t0,
            "launches": {"dequant_scatter": dsc.launches, **fa.launches,
                         **fused_ce.launches},
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "held_before_bytes": held,
            "collective_ms": ms,
            "collectives": [{"op": k[0], "backend": k[1], "route": k[2], **v}
                            for k, v in sorted(coll.counts.items())]}


def _mr_rounds(mesh, dirs: dict, tok) -> dict:
    """(a) and (b) in this process: world 1 with ``mesh`` None, else one
    rank of ``mesh``'s world (every rank calls this at once). Each round's
    launches, seconds, peak card memory and collectives are this
    process's."""
    import dataclasses as dc
    import torch
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.average import (
        AveragerLoop, ParameterizedMerge, WeightedAverage)
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.engine.validate import Validator
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.parallel import multihost
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    cfg = gpt2.PRESETS["gpt2-124m"]
    held = _batches(tok, split="test", batch_size=MINER_B, seq_len=EVAL_T,
                    n=VAL_EVAL_BATCHES)

    def io(name, hotkey):
        t = _Calls(LocalFSTransport(os.path.join(dirs[name], "artifacts")))
        c = _Calls(LocalChain(os.path.join(dirs[name], "chain"),
                              my_hotkey=hotkey))
        return (t, c) + multihost.gate_io(t, c)

    res: dict = {}
    # (a) f32, so that the scores compare with world 1's at 1e-5
    eng32 = TrainEngine(gpt2.make_model(dc.replace(cfg, dtype="float32"))[0],
                        mesh=mesh, device=DEV)
    t, c, gt, gch = io("val", "hotkey_91")
    v = Validator(eng32, gt, gch, eval_batches=lambda: iter(held),
                  cohort_size=8)
    secs: dict = {}
    _timed_calls(v._evaluator(), "evaluate_stacked", secs)

    def val_round():
        v.bootstrap()
        return {s.hotkey: [s.score, s.loss, s.reason]
                for s in v.validate_and_score()}

    m = _mr_measured(val_round)
    v.close()
    cb = v._evaluator().candidate_batches
    res["val"] = {**m, "scores": m.pop("out"), "base_loss": v.base_loss,
                  "candidate_batches": cb, "eval_s": secs["evaluate_stacked"],
                  "eval_ms_per_candidate_batch": (
                      secs["evaluate_stacked"] * 1e3 / cb if cb else None),
                  "set_weights": c.calls.get("set_weights", 0),
                  "transport_calls": sum(t.calls.values())}
    del v, eng32
    torch.cuda.empty_cache()
    # (b) bf16, the averager's defaults but the publish policy
    model = gpt2.make_model(cfg)[0]
    eng = TrainEngine(model, mesh=mesh, device=DEV)
    for name, strategy in (("weighted", WeightedAverage()),
                           ("param", ParameterizedMerge(
                               model, meta_epochs=META_EPOCHS))):
        t, c, gt, gch = io(name, "hotkey_95")
        loop = AveragerLoop(eng, gt, gch, strategy,
                            val_batches=lambda: iter(held),
                            publish_policy="always")
        loop.bootstrap()
        secs, kept = {}, {}
        _timed_calls(loop.strategy, "merge", secs, kept)
        m = _mr_measured(loop.run_round)
        loop.close()
        _, w = kept["merge"]
        res[name] = {**m, "merged": m.pop("out"),
                     "accepted": loop.report.last_accepted,
                     "merge_s": secs["merge"],
                     "publishes": t.calls.get("publish_base", 0),
                     "revision": loop._base_revision,
                     "weights": ({k: x.detach().cpu().tolist()
                                  for k, x in w.items()}
                                 if isinstance(w, dict) else
                                 torch.as_tensor(w).tolist())}
        del loop
    return res


def mesh_roles_worker(rank: int, port: int, tmp: str) -> int:
    """One rank of phase 24's world (``--mesh-roles-worker``): (a) and
    (b) on a dp mesh over every rank; its results in
    ``tmp/out_<rank>.json``."""
    import torch
    from distributedtraining_tpu_torch.parallel import (Mesh, MeshConfig,
                                                        multihost)
    sys.path.insert(0, ROOT)
    with open(os.path.join(tmp, "spec.json")) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = spec["n"]
    multihost.initialize(f"127.0.0.1:{port}", n, rank, device=DEV,
                         backend=spec["backend"], timeout_s=PAR_TIMEOUT_S)
    import torch.distributed as dist
    out = {"rank": rank, "backend": dist.get_backend(),
           "device": torch.cuda.current_device()}
    try:
        out.update(_mr_rounds(Mesh(MeshConfig(dp=n)), spec["dirs"],
                              _tokenizer()))
    finally:
        multihost.shutdown()
    return _par_worker_done(tmp, rank, out)


def mesh_roles_cli(rank: int, port: int, tmp: str) -> int:
    """One process of a CLI of (c) (``--mesh-roles-cli``): the entry
    point of ``cli.json`` on its argv and this rank's ``--multihost-*``
    flags, with the local chain's ``set_weights``, the transport's
    ``publish_base`` and the lease's ``acquire`` and ``stamp`` counted
    and the launch counts at 0 before; its
    return code, counts, launches and seconds in ``tmp/out_<rank>.json``
    (the entry point brings its world up and down itself)."""
    import importlib
    import torch
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.remediate import LeaseManager
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    sys.path.insert(0, ROOT)
    with open(os.path.join(tmp, "spec.json")) as f:
        spec = json.load(f)
    counts: dict = {}
    for cls, name in ((LocalChain, "set_weights"),
                      (LocalFSTransport, "publish_base"),
                      (LeaseManager, "acquire"), (LeaseManager, "stamp")):
        def counted(self, *a, _f=getattr(cls, name), _n=name, **kw):
            counts[_n] = counts.get(_n, 0) + 1
            return _f(self, *a, **kw)
        setattr(cls, name, counted)
    role = importlib.import_module(
        f"distributedtraining_tpu_torch.neurons.{spec['role']}")
    _zero_counts()
    dsc.launches = 0
    t0 = time.perf_counter()
    rc = role.main(spec["argv"] + [
        "--multihost-coordinator", f"127.0.0.1:{port}",
        "--multihost-processes", str(spec["n"]), "--multihost-id",
        str(rank)])
    torch.cuda.synchronize()
    return _par_worker_done(tmp, rank, {
        "rc": rc, "counts": counts, "s": time.perf_counter() - t0,
        "launches": {"dequant_scatter": dsc.launches, **fa.launches,
                     **fused_ce.launches}})


def _mr_cli(n: int, backend: str, role: str, argv: list, what: str
            ) -> list:
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return _par_spawn(n, backend, {"role": role, "argv": argv, "n": n},
                          tmp, what, mode="--mesh-roles-cli")


def _mr_check(what: str, n: int, w1: dict, outs: list, cfg, dirs: dict,
              deltas: list, tree) -> dict:
    """(a) and (b) of a world against world 1 (see the docstring of
    :func:`phase_mesh_roles`); every reading logged before the first
    check."""
    import numpy as np
    import torch
    from distributedtraining_tpu_torch import delta
    from distributedtraining_tpu_torch.engine.train import _wire_template
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    L = cfg.n_layer
    # (a) the validator's round
    ref = w1["val"]["scores"]
    val_rel = {}
    for h, (score, loss, reason) in ref.items():
        if loss is not None:
            got = outs[0]["val"]["scores"][h]
            val_rel[h] = {"loss_rel": abs(got[1] - loss) / abs(loss),
                          "score_rel": abs(got[0] - score)
                          / max(abs(score), 1e-30)}
    log(f"{what} validator:", json.dumps(
        {"rel": val_rel, "launches": [o["val"]["launches"] for o in outs],
         "candidate_batches": [o["val"]["candidate_batches"] for o in outs],
         "set_weights": [o["val"]["set_weights"] for o in outs]}))
    for r, o in enumerate(outs):
        check(o["val"]["scores"] == outs[0]["val"]["scores"],
              f"{what} validator rank {r}: scores differ from rank 0's")
        lc = o["val"]["launches"]
        check(lc["flash_attention_fwd"] == L * o["val"]["candidate_batches"]
              and not any(x for k, x in lc.items()
                          if k != "flash_attention_fwd"),
              f"{what} validator rank {r}: launches {lc} != 12 x "
              f"{o['val']['candidate_batches']} candidate-batches of the "
              f"flash forward and nothing else")
        check(r == 0 or o["val"]["transport_calls"] == 0,
              f"{what} validator rank {r} read the transport "
              f"({o['val']['transport_calls']} calls)")
    check(sum(o["val"]["candidate_batches"] for o in outs)
          == w1["val"]["candidate_batches"],
          f"{what} validator: the ranks evaluated "
          f"{[o['val']['candidate_batches'] for o in outs]} "
          f"candidate-batches, world 1 {w1['val']['candidate_batches']}")
    check([o["val"]["set_weights"] for o in outs] == [1] + [0] * (n - 1),
          f"{what} validator: set_weights by rank "
          f"{[o['val']['set_weights'] for o in outs]}")
    got = outs[0]["val"]["scores"]
    mag = float(np.float32(127.0) * np.float32(1e6))
    check(got["hotkey_5"][2] == "no_delta"
          and got["hotkey_6"][2] == f"magnitude_exceeded({mag:.3e}>"
                                    f"{1e3:.3e})"
          and got["hotkey_5"][0] == got["hotkey_6"][0] == 0.0,
          f"{what} validator: hostiles {got['hotkey_5']}, "
          f"{got['hotkey_6']}")
    check(all(got[h][2] == "ok" and got[h][0] > 0 for h in HONEST),
          f"{what} validator: honest miners {[got[h] for h in HONEST]}")
    for h, rel in val_rel.items():
        check(rel["loss_rel"] <= 1e-5 and (h not in HONEST
                                           or rel["score_rel"] <= 1e-5),
              f"{what} validator {h}: {rel} against world 1 (1e-5)")
    # (b) the averager's rounds; the learned logits of every rank against
    # world 1's, and world 1's own distance from their start (0)
    w1_logits = w1["param"]["weights"]
    logit_diff = [max(float(np.abs(np.array(x) - np.array(w1_logits[k])
                                   ).max())
                      for k, x in o["param"]["weights"].items())
                  for o in outs]
    log(f"{what} param logits:", json.dumps(
        {"vs_world1_by_rank": logit_diff, "world1_moved": max(
            float(np.abs(np.array(x)).max()) for x in w1_logits.values()),
         "limit": PARAM_LOGITS_LIMIT}))
    want = {"weighted": L * VAL_EVAL_BATCHES}
    steps = META_EPOCHS * VAL_EVAL_BATCHES
    for name in ("weighted", "param"):
        runs = [o[name] for o in outs]
        log(f"{what} {name} round:", json.dumps(
            {"launches": [x["launches"] for x in runs],
             "publishes": [x["publishes"] for x in runs],
             "s": [x["s"] for x in runs]}))
        for r, x in enumerate(runs):
            lc = x["launches"]
            check(x["merged"] and x["accepted"] == 3,
                  f"{what} {name} rank {r}: merged {x['merged']}, accepted "
                  f"{x['accepted']}")
            check(x["revision"] == runs[0]["revision"] and
                  x["weights"] == runs[0]["weights"],
                  f"{what} {name} rank {r}: revision or weights differ "
                  f"from rank 0's")
            if name == "weighted":
                ok = (lc["flash_attention_fwd"] == want[name]
                      and not any(v for k, v in lc.items()
                                  if k != "flash_attention_fwd"))
            else:
                ok = (lc["flash_attention_fwd"] == L * (steps
                                                       + VAL_EVAL_BATCHES)
                      and lc["flash_attention_bwd_dkv"] == L * steps
                      and lc["flash_attention_bwd_dq"] == L * steps
                      and not any(lc[k] for k in (
                          "dequant_scatter", "fused_ce_fwd",
                          "fused_ce_bwd_dh", "fused_ce_bwd_dw")))
            check(ok, f"{what} {name} rank {r}: launches {lc}")
        check([x["publishes"] for x in runs] == [1] + [0] * (n - 1),
              f"{what} {name}: publishes by rank "
              f"{[x['publishes'] for x in runs]}")
    template = _wire_template(gpt2.make_model(cfg)[0])
    fetched = LocalFSTransport(os.path.join(
        dirs["weighted"], "artifacts")).fetch_base(template)
    got_w = delta.flatten_tree(fetched[0])
    w_err = max(float(np.abs(np.asarray(got_w[k], np.float64)
                             - np.asarray(w1["weighted_base"][k],
                                          np.float64)).max())
                for k in got_w)
    pub = gpt2.params_from_numpy(LocalFSTransport(os.path.join(
        dirs["param"], "artifacts")).fetch_base(template)[0], device="cpu")
    base = gpt2.params_from_numpy(tree, device="cpu")
    placed = [delta.place_delta(d, base) for d in deltas]
    norm = {k: torch.softmax(torch.tensor(x), dim=0)
            for k, x in outs[0]["param"]["weights"].items()}
    plain = delta.per_tensor_weighted_merge(base, placed, norm)
    p_err = max(float((pub[k] - plain[k]).abs().max()) for k in pub)
    logit_diff = max(logit_diff)
    log(f"{what} published bases:", json.dumps(
        {"weighted_vs_world1": w_err, "param_vs_plain": p_err,
         "param_logits_vs_world1": logit_diff}))
    check(w_err <= 1e-6, f"{what} weighted: published base vs world 1's: "
                         f"max abs {w_err} > 1e-6")
    check(p_err <= 1e-6, f"{what} parameterized: published base vs the "
                         f"plain mixture at its logits: max abs {p_err}")
    check(logit_diff <= PARAM_LOGITS_LIMIT,
          f"{what} parameterized: learned logits {logit_diff} from world "
          f"1's > {PARAM_LOGITS_LIMIT}")
    return {"val_rel": val_rel, "weighted_vs_world1": w_err,
            "param_vs_plain": p_err, "param_logits_vs_world1": logit_diff}


def _mr_summary(rounds: dict) -> dict:
    """A world's (or a rank's) readings without the scores' detail."""
    keep = ("s", "launches", "peak_bytes", "held_before_bytes",
            "collective_ms", "collectives")
    out = {name: {k: r[k] for k in keep}
           for name, r in rounds.items() if isinstance(r, dict)
           and "launches" in r}
    for name in ("weighted", "param"):
        if name in rounds:
            out[name]["merge_s"] = rounds[name]["merge_s"]
    for k in ("candidate_batches", "eval_s", "eval_ms_per_candidate_batch"):
        out["val"][k] = rounds["val"][k]
    return out


def phase_mesh_roles(tree, tok, n: int = 2, backend: str = "gloo") -> dict:
    """Phase 24 (see the module docstring): phase 17's submissions on a
    fresh root; (a) and (b) at world 1 in this process, then at world
    ``n`` in child processes (gloo: every rank on this card; NCCL: rank r
    on card r), checked against world 1; then (c) both CLIs as ``n``
    processes joined by ``--multihost-*``."""
    import tempfile
    import torch
    from distributedtraining_tpu_torch import delta
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.ingest import DeltaIngestor
    from distributedtraining_tpu_torch.engine.train import _wire_template
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    cfg = gpt2.PRESETS["gpt2-124m"]
    what = f"world {n} ({backend})"
    t_start = time.perf_counter()
    res: dict = {"world": n, "backend": backend, "model": "gpt2-124m",
                 "eval_batches": VAL_EVAL_BATCHES, "eval_seq_len": EVAL_T,
                 "meta_steps": META_EPOCHS * VAL_EVAL_BATCHES}
    template = _wire_template(gpt2.make_model(cfg)[0])
    with tempfile.TemporaryDirectory() as work:
        fleet = os.path.join(work, "fleet")
        t0 = time.perf_counter()
        rev = _mr_fleet(tree, tok, fleet)
        res["fleet_s"] = time.perf_counter() - t0
        # the merges' inputs, densified on the host, for (b)'s plain check
        ing = DeltaIngestor(LocalFSTransport(fleet), template,
                            stale_deltas="skip")
        deltas = [s.delta for s in ing.stage(list(HONEST),
                                             base_revision=rev)]
        ing.close()
        check(all(d is not None for d in deltas), "the honest miners' "
              "submissions did not stage")
        d1 = _mr_dirs(fleet, os.path.join(work, "w1"))
        t0 = time.perf_counter()
        w1 = _mr_rounds(None, d1, tok)
        res["world1_s"] = time.perf_counter() - t0
        w1["weighted_base"] = delta.flatten_tree(LocalFSTransport(
            os.path.join(d1["weighted"], "artifacts")).fetch_base(
                template)[0])
        gc.collect()
        torch.cuda.empty_cache()
        dn = _mr_dirs(fleet, os.path.join(work, f"w{n}"), cli=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            outs = _par_spawn(n, backend, {"n": n, "backend": backend,
                                           "dirs": dn}, tmp, what,
                              mode="--mesh-roles-worker")
        res["world_s"] = time.perf_counter() - t0
        res["checks"] = _mr_check(what, n, w1, outs, cfg, dn, deltas, tree)
        del deltas, w1["weighted_base"]
        # (c) the CLIs
        cli = {}
        t0 = time.perf_counter()
        argv = README_VALIDATOR_FLAGS + MR_CLI_FLAGS + [
            "--work-dir", dn["cli_val"], "--hotkey", "hotkey_91"]
        runs = _mr_cli(n, backend, "validator", argv,
                       f"{what} validator CLI")
        weights = LocalChain(os.path.join(dn["cli_val"], "chain")
                             ).get_weights("hotkey_91")
        check(all(x["rc"] == 0 for x in runs) and any(weights.values())
              and [x["counts"].get("set_weights", 0) for x in runs]
              == [1] + [0] * (n - 1),
              f"{what} validator CLI: rc {[x['rc'] for x in runs]}, "
              f"set_weights {[x['counts'] for x in runs]}")
        cli["validator"] = {"argv": argv, "s": time.perf_counter() - t0,
                            "ranks": runs}
        t0 = time.perf_counter()
        argv = [f for f in README_AVERAGER_FLAGS
                if f not in ("--strategy", "weighted")] + MR_CLI_FLAGS + [
            "--meta-epochs", "1", "--publish-policy", "always",
            "--work-dir", dn["cli_avg"], "--hotkey", "hotkey_95"]
        runs = _mr_cli(n, backend, "averager", argv, f"{what} averager CLI")
        new = LocalFSTransport(os.path.join(dn["cli_avg"], "artifacts")
                               ).base_revision()
        check(all(x["rc"] == 0 for x in runs) and new not in (None, rev)
              and [x["counts"].get("publish_base", 0) for x in runs]
              == [1] + [0] * (n - 1)
              and all(x["launches"]["flash_attention_bwd_dq"] > 0
                      and x["launches"]["dequant_scatter"] == 0
                      for x in runs),
              f"{what} averager CLI: rc {[x['rc'] for x in runs]}, "
              f"publish_base {[x['counts'] for x in runs]}, launches "
              f"{[x['launches'] for x in runs]}")
        cli["averager"] = {"argv": argv, "s": time.perf_counter() - t0,
                           "ranks": runs}
    res.update(world1=_mr_summary(w1), ranks=[_mr_summary(o) for o in outs],
               scores={h: x[0] for h, x in outs[0]["val"]["scores"].items()
                       if x[1] is not None},
               base_loss=outs[0]["val"]["base_loss"], cli=cli,
               s=time.perf_counter() - t_start)
    log("mesh roles:", json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# Phase 25: sequence parallelism, remat and mu_dtype
# ---------------------------------------------------------------------------

SP_T = 1024
SP_F32_B, SP_F32_STEPS = 2, 3
SP_STEP_B = 4
SP_CLI_B, SP_CLI_STEPS = 8, 3
SP_DCN_T = 128
# the ring against the dense plain attention: JAX's own f32 tolerance
# (tests/test_ring_attention.py), and bf16 over the largest value
SP_RING_TOL = {"float32": (2e-4, 2e-5), "bfloat16": 2e-2}
SP_REMAT_TOL = 1e-6      # f32 gradients with remat, relative to the max
SP_BATCHES = ("f32_packed", "step_packed", "f32_plain", "step_plain")


def _sp_n_params(tree) -> int:
    return sum(int(v.size) for v in _leaves(tree))


def _sp_step_want(cfg, rows: int, route: str, n_params: int) -> dict:
    """``{op: [calls, bytes]}`` of one fused-loss step without a clip on a
    mesh of sp 2 alone, a rank's ``rows`` rows of ``SP_T`` positions.
    No parameter is split, so nothing is gathered. The gathered route:
    each block all-gathers its stacked q|k|v ``[rows, T/2, 3, E]`` over
    sp (the output's bytes, the compute dtype) and reduce-scatters its
    cotangent (the input's bytes). The ring: each block passes the
    stacked K|V ``[2, rows, T/2, E]`` once (sp - 1 steps) and its
    cotangent back once. Both: the CE's two f32 totals and one f32
    all-reduce of every gradient over sp."""
    import torch
    L, E = cfg.n_layer, cfg.n_embd
    act = torch.empty((), dtype=cfg.compute_dtype()).element_size()
    sums = {"all_reduce": [3, 8 + 4 * n_params]}
    if route == "gathered":
        qkv = act * rows * SP_T * 3 * E
        return {"all_gather": [L, L * qkv], "reduce_scatter": [L, L * qkv],
                **sums}
    kv = act * 2 * rows * (SP_T // 2) * E
    return {"ring_pass": [2 * L, 2 * L * kv], **sums}


def _sp_ring_check(dev, mesh) -> dict:
    """``ops.ring_attention`` on this rank's block of q, k, v ``[2, T, 12,
    64]`` (drawn on the host from the seed, the same on every rank), its
    output and the gradients of a cotangent, against the dense plain
    attention of the whole sequence (``dot_product_attention`` with the
    causal mask, autograd) at this rank's block: f32 within JAX's
    tolerance, bf16 within ``SP_RING_TOL`` of the largest value."""
    import torch
    from distributedtraining_tpu_torch.ops.attention import (
        dot_product_attention, make_causal_mask)
    from distributedtraining_tpu_torch.ops.ring_attention import \
        ring_attention
    B, H, D = SP_F32_B, 12, 64
    n, i = mesh.size("sp"), mesh.index("sp")
    per = SP_T // n
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(SEED + 25)
        full = [torch.randn((B, SP_T, H, D), generator=gen).to(dev, dt)
                for _ in range(4)]
        mine = [x[:, i * per:(i + 1) * per].clone().requires_grad_()
                for x in full[:3]]
        o = ring_attention(*mine, mesh=mesh)
        o.backward(full[3][:, i * per:(i + 1) * per])
        ref_in = [x.clone().requires_grad_() for x in full[:3]]
        mask = make_causal_mask(SP_T, device=dev)[None, None]
        ref = dot_product_attention(*ref_in, mask)
        ref.backward(full[3])
        pairs = {"o": (o, ref)}
        for name, a, b in zip(("dq", "dk", "dv"), mine, ref_in):
            pairs[name] = (a.grad, b.grad)
        errs = {}
        for name, (a, b) in pairs.items():
            b = b[:, i * per:(i + 1) * per] if b.shape[1] == SP_T else b
            a, b = a.detach().float(), b.detach().float()
            diff = (a - b).abs()
            if dt == torch.float32:
                rtol, atol = SP_RING_TOL["float32"]
                errs[name] = float((diff - rtol * b.abs()).max())
                check(errs[name] <= atol,
                      f"ring f32 {name}: |ring - dense| - {rtol} |dense| "
                      f"= {errs[name]} > {atol}")
            else:
                errs[name] = float(diff.max() / b.abs().max())
                check(errs[name] <= SP_RING_TOL["bfloat16"],
                      f"ring bf16 {name}: {errs[name]} of the max > "
                      f"{SP_RING_TOL['bfloat16']}")
        out[str(dt).split(".")[1]] = errs
    return out


def _sp_arrays(tmp: str) -> dict:
    """The global batches of the phase, as the main process wrote them:
    ``{name: [batch dict, ...]}``."""
    return _sp_arrays_from(os.path.join(tmp, "sp_batches.npz"))


def _sp_arrays_from(path: str) -> dict:
    """Batches saved as ``name/i/field`` arrays in the npz at ``path``:
    ``{name: [batch dict, ...]}``."""
    import numpy as np
    data = np.load(path)
    out: dict = {}
    for key in data.files:
        name, i, field = key.split("/")
        while len(out.setdefault(name, [])) <= int(i):
            out[name].append({})
        out[name][int(i)][field] = data[key]
    return out


def sp_worker(rank: int, port: int, tmp: str) -> int:
    """One rank of phase 25's world of two (``--sp-worker``): the ring
    checks, the f32 losses of the gathered and the ring sp2 engines, the
    timed bf16 steps of sp2 (both routes) and tp2 at B 4 x T 1024, then
    the ``--sp 2`` and ``--dp 2 --dcn-dp 2`` miner CLIs; its results in
    ``tmp/out_<rank>.json``. Any failed collective, kernel or check
    raises, and the process exits non-zero."""
    import torch
    from distributedtraining_tpu_torch.delta import flatten_tree
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.parallel import (Mesh, MeshConfig,
                                                        multihost)
    sys.path.insert(0, ROOT)
    with open(os.path.join(tmp, "spec.json")) as f:
        spec = json.load(f)
    dev = DEV
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"127.0.0.1:{port}", 2, rank, device=dev,
                         backend=spec["backend"], timeout_s=PAR_TIMEOUT_S)
    import torch.distributed as dist
    out = {"rank": rank, "backend": dist.get_backend()}
    try:
        batches = _sp_arrays(tmp)
        sp2 = Mesh(MeshConfig(sp=2))
        out["ring_check"] = _sp_ring_check(dev, sp2)
        tree = flatten_tree(gpt2.init_params_numpy(
            gpt2.PRESETS[PAR_MODEL], SEED))
        cfg = gpt2.PRESETS[PAR_MODEL]
        ring = dataclasses.replace(cfg, attention_impl="ring")
        f32 = dataclasses.replace(cfg, dtype="float32")
        f32_ring = dataclasses.replace(ring, dtype="float32")
        out["f32_losses"] = {
            "gathered": _par_engine_losses(f32, tree,
                                           batches["f32_packed"], sp2, dev),
            "ring": _par_engine_losses(f32_ring, tree, batches["f32_plain"],
                                       sp2, dev)}
        tp2 = Mesh(MeshConfig(tp=2))
        out["step"] = {
            name: _par_engine_step(c, tree, m, dev, profile=False,
                                   batch=batches[b][0])
            for name, c, m, b in (("sp2", cfg, sp2, "step_packed"),
                                  ("sp2_ring", ring, sp2, "step_plain"),
                                  ("tp2", cfg, tp2, "step_packed"))}
        del tree
        out["cli"] = {
            name: _par_worker_cli(dev, flags, spec["cli_work"][name],
                                  b=SP_CLI_B, t=t, steps=SP_CLI_STEPS)
            for name, flags, t in (
                ("sp2", ["--sp", "2"], SP_T),
                ("dcn", ["--dp", "2", "--dcn-dp", "2"], SP_DCN_T))}
    finally:
        multihost.shutdown()
    return _par_worker_done(tmp, rank, out)


def _sp_check_run(what: str, run: dict, route: str, rows: int, steps: int,
                  n_params: int) -> None:
    """A world-2 sp2 run's launches (12 a step of each flash kernel on
    the gathered route, none on the ring; one of each CE kernel) and
    every step's collectives, exactly."""
    from distributedtraining_tpu_torch.models import gpt2
    cfg = gpt2.PRESETS[PAR_MODEL]
    want = _train_want(cfg, steps, fused=True)
    if route == "ring":
        want = {k: (0 if k.startswith("flash") else v)
                for k, v in want.items()}
    _check_launches(what, run["launches"], want)
    want_c = _sp_step_want(cfg, rows, route, n_params)
    for i, c in enumerate(run["collectives"]):
        check(c == want_c, f"{what}: step {i} collectives {c} != {want_c}")


def _sp_world1(tree, batches: dict) -> dict:
    """World 1 in this process: the f32 losses of the engine on the
    packed batches (flash) and of the ring model on the unpacked ones
    (no mesh: dense attention), and a timed bf16 step at B 4 x T 1024."""
    from distributedtraining_tpu_torch.delta import flatten_tree
    from distributedtraining_tpu_torch.models import gpt2
    flat = flatten_tree(tree)
    cfg = gpt2.PRESETS[PAR_MODEL]
    f32 = dataclasses.replace(cfg, dtype="float32")
    return {"f32_losses": {
        "gathered": _par_engine_losses(f32, flat, batches["f32_packed"],
                                       None, DEV),
        "ring": _par_engine_losses(dataclasses.replace(
            f32, attention_impl="ring"), flat, batches["f32_plain"], None,
            DEV)},
        "step": _par_engine_step(cfg, flat, None, DEV, profile=False,
                                 batch=batches["step_packed"][0])}


def _sp_world2(tree, tok, batches: dict, w1: dict) -> dict:
    """The world of two over gloo, both ranks on this card
    (``--sp-worker``), checked against world 1 and the exact counts."""
    import tempfile

    import numpy as np
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    what = "phase 25 world 2 (gloo)"
    n_params = _sp_n_params(tree)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "sp_batches.npz"), **{
            f"{name}/{i}/{k}": v for name, bs in batches.items()
            for i, b in enumerate(bs) for k, v in b.items()})
        cli_work = {}
        for name in ("sp2", "dcn"):
            work = os.path.join(tmp, f"cli_{name}")
            LocalFSTransport(os.path.join(work, "artifacts")).publish_base(
                tree)
            cli_work[name] = work
        outs = _par_spawn(2, "gloo", {"backend": "gloo",
                                      "cli_work": cli_work}, tmp, what,
                          mode="--sp-worker")
        res = {"backend": [o["backend"] for o in outs],
               "ring_check": [o["ring_check"] for o in outs]}
        for route in ("gathered", "ring"):
            for r, o in enumerate(outs):
                got, ref = o["f32_losses"][route], w1["f32_losses"][route]
                rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
                check(rel <= 1e-4, f"{what} f32 {route} rank {r}: losses "
                                   f"{got} vs world 1 {ref}: {rel}")
            res[f"f32_{route}"] = {
                "losses": [o["f32_losses"][route] for o in outs],
                "world1": w1["f32_losses"][route],
                "max_rel": max(abs(a - b) / abs(b) for o in outs
                               for a, b in zip(o["f32_losses"][route],
                                               w1["f32_losses"][route]))}
        steps = {}
        for name in ("sp2", "sp2_ring", "tp2"):
            runs = [o["step"][name] for o in outs]
            for r, run in enumerate(runs):
                n = len(run["step_collectives"])
                if name == "tp2":
                    _check_launches(f"{what} {name} rank {r}",
                                    run["step_launches"], _train_want(
                                        _par_cfg(), n, fused=True))
                else:
                    _sp_check_run(
                        f"{what} {name} rank {r}",
                        {"launches": run["step_launches"],
                         "collectives": run["step_collectives"]},
                        "ring" if name.endswith("ring") else "gathered",
                        SP_STEP_B, n, n_params)
            steps[name] = {
                "step_ms": [x["step_ms"] for x in runs],
                "step_peak_bytes": [x["step_peak_bytes"] for x in runs],
                "step_collectives": runs[0]["step_collectives"][-1],
                "step_launches": runs[0]["step_launches"]}
        res["step"] = steps
        cli = {}
        for name, work in cli_work.items():
            runs = [o["cli"][name] for o in outs]
            for r, run in enumerate(runs):
                check(run["rc"] == 0 and run["steps"] == SP_CLI_STEPS,
                      f"{what} CLI {name} rank {r}: rc {run['rc']}, steps "
                      f"{run['steps']}")
                check(run["boot_bit_equal"], f"{what} CLI {name} rank {r}: "
                      f"shards after the pull differ from the base's")
                if name == "sp2":
                    _sp_check_run(f"{what} CLI sp2 rank {r}",
                                  {"launches": run["launches"],
                                   "collectives": run["step_collectives"]},
                                  "gathered", SP_CLI_B, run["steps"],
                                  n_params)
                else:
                    _check_launches(f"{what} CLI {name} rank {r}",
                                    run["launches"], _train_want(
                                        _par_cfg(), run["steps"],
                                        fused=True))
            check(runs[0]["pushes"] == 1 and runs[0]["pushes_failed"] == 0
                  and runs[1]["pushes"] == 0,
                  f"{what} CLI {name}: pushes {[x['pushes'] for x in runs]}"
                  f" (one, from the coordinator)")
            if name == "dcn":
                from distributedtraining_tpu_torch.parallel.mesh import (
                    MeshConfig, rank_coords)
                want = [rank_coords(r, MeshConfig(dp=2)) for r in range(2)]
                check([x["coords"] for x in runs] == want,
                      f"{what} CLI dcn: coordinates "
                      f"{[x['coords'] for x in runs]} != --dp 2's {want}")
            cli[name] = {"argv": runs[0]["argv"],
                         "s": [x["s"] for x in runs],
                         "pushes": [x["pushes"] for x in runs],
                         "launches": [x["launches"] for x in runs],
                         "step_collectives": runs[0]["step_collectives"][-1],
                         "mesh": runs[0]["mesh"],
                         "coords": [x["coords"] for x in runs],
                         **_par_score(tree, tok, work)}
        res["cli"] = cli
    res["s"] = time.perf_counter() - t0
    return res


def _par_cfg():
    """The mesh phases' model configuration (``PAR_MODEL``)."""
    from distributedtraining_tpu_torch.models import gpt2
    return gpt2.PRESETS[PAR_MODEL]


def _sp_remat_mu(tree, batch: dict) -> dict:
    """World 1: f32 gradients of one loss with and without remat at the
    train shape (B 8 x T 1024, packed), the peak card memory of a timed
    bf16 step with and without remat, and the optimizer state's bytes
    and dtypes with ``mu_dtype="bfloat16"``."""
    import torch
    from distributedtraining_tpu_torch.delta import flatten_tree
    from distributedtraining_tpu_torch.engine.train import (
        TrainEngine, default_optimizer)
    from distributedtraining_tpu_torch.models import gpt2
    flat = flatten_tree(tree)
    cfg = gpt2.PRESETS[PAR_MODEL]
    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, dtype="float32", remat=remat)
        eng = TrainEngine(gpt2.make_model(c)[0], fused_loss=True, device=DEV)
        params = eng.place_params(flat)
        loss, _ = eng._loss(params, eng.place_batch(batch))
        grads[remat] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        del eng, params, loss
        torch.cuda.empty_cache()
    rel = max(float((grads[True][k] - g).abs().max()
                    / g.abs().max().clamp(min=1e-30))
              for k, g in grads[False].items())
    bit_equal = all(torch.equal(grads[True][k], g)
                    for k, g in grads[False].items())
    del grads
    torch.cuda.empty_cache()
    check(rel <= SP_REMAT_TOL, f"remat f32 gradients differ by {rel} of "
                               f"the max > {SP_REMAT_TOL}")
    steps = {name: _par_engine_step(dataclasses.replace(cfg, remat=remat),
                                    flat, None, DEV, profile=False,
                                    batch=batch)
             for name, remat in (("plain", False), ("remat", True))}
    for name, run in steps.items():
        want = _train_want(cfg, len(run["step_collectives"]), fused=True)
        if name == "remat":   # the recomputed forward launches again
            want["flash_attention_fwd"] *= 2
        _check_launches(f"bf16 step {name}", run["step_launches"], want)
    state_bytes = {}
    for mu_dtype in (None, "bfloat16"):
        eng = TrainEngine(gpt2.make_model(cfg)[0], device=DEV,
                          optimizer=default_optimizer(mu_dtype=mu_dtype))
        opt = eng.init_state(flat).opt_state
        dtypes = sorted({str(v.dtype) for v in opt.mu.values()})
        state_bytes[str(mu_dtype)] = {
            "mu_dtypes": dtypes,
            "bytes": sum(v.numel() * v.element_size()
                         for tr in (opt.mu, opt.nu) for v in tr.values())}
        del eng, opt
        torch.cuda.empty_cache()
    n_params = _sp_n_params(tree)
    saved = state_bytes["None"]["bytes"] - state_bytes["bfloat16"]["bytes"]
    check(state_bytes["bfloat16"]["mu_dtypes"] == ["torch.bfloat16"]
          and saved == 2 * n_params,
          f"mu_dtype bfloat16: mu dtypes "
          f"{state_bytes['bfloat16']['mu_dtypes']}, {saved} bytes saved "
          f"!= 2 x {n_params}")
    return {"grads_max_rel": rel, "grads_bit_equal": bit_equal,
            "step": {k: {"step_ms": v["step_ms"],
                         "step_peak_bytes": v["step_peak_bytes"],
                         "step_launches": v["step_launches"]}
                     for k, v in steps.items()},
            "remat_peak_saved_bytes": (steps["plain"]["step_peak_bytes"]
                                       - steps["remat"]["step_peak_bytes"]),
            "opt_state": state_bytes, "mu_bytes_saved": saved,
            "n_params": n_params}


def _sp_cli_world1(tree) -> dict:
    """``neurons.miner.main`` at world 1 with ``--remat --mu-dtype
    bfloat16`` (B 8 x T 1024, 3 steps): rc 0, one push, the launches
    (the recomputed forward launches the flash forward again)."""
    import tempfile

    import torch
    from distributedtraining_tpu_torch.engine import train as ttrain
    from distributedtraining_tpu_torch.neurons import miner as miner_cli
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    seen = {}
    bootstrap = ttrain.MinerLoop.bootstrap

    def watched(loop, *a, **kw):
        bootstrap(loop, *a, **kw)
        seen["loop"] = loop

    with tempfile.TemporaryDirectory() as work:
        LocalFSTransport(os.path.join(work, "artifacts")).publish_base(tree)
        argv = README_MINER_FLAGS + [
            "--remat", "--mu-dtype", "bfloat16", "--work-dir", work,
            "--batch-size", str(SP_CLI_B), "--seq-len", str(SP_T),
            "--max-steps", str(SP_CLI_STEPS)]
        ttrain.MinerLoop.bootstrap = watched
        try:
            _zero_counts()
            t0 = time.perf_counter()
            rc = miner_cli.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            ttrain.MinerLoop.bootstrap = bootstrap
        launches = {**fa.launches, **fused_ce.launches}
        loop = seen["loop"]
        mu = sorted({str(v.dtype) for v in loop.state.opt_state.mu.values()})
        res = {"argv": argv, "rc": rc, "s": secs, "pushes": loop.report.pushes,
               "steps": loop.report.steps, "launches": launches,
               "remat": loop.engine.model.cfg.remat, "mu_dtypes": mu}
    want = _train_want(_par_cfg(), res["steps"], fused=True)
    want["flash_attention_fwd"] *= 2
    check(rc == 0 and res["pushes"] == 1 and res["remat"]
          and mu == ["torch.bfloat16"],
          f"--remat --mu-dtype bfloat16 CLI: rc {rc}, pushes "
          f"{res['pushes']}, remat {res['remat']}, mu {mu}")
    _check_launches("--remat --mu-dtype bfloat16 CLI", launches, want)
    return res


def phase_sp(tree, tok) -> dict:
    """Phase 25 (see the module docstring): world 1 in this process, the
    world of two over gloo on this card, then remat and mu_dtype at
    world 1."""
    import torch
    t0 = time.perf_counter()
    packed = _batches(tok, split="train", batch_size=SP_STEP_B,
                      seq_len=SP_T, n=SP_F32_STEPS)
    batches = {
        "f32_packed": [{k: v[:SP_F32_B] for k, v in b.items()}
                       for b in packed],
        "step_packed": packed[:1],
        "f32_plain": [{"input_ids": b["input_ids"][:SP_F32_B]}
                      for b in packed],
        "step_plain": [{"input_ids": packed[0]["input_ids"]}]}
    res = {"world1": _sp_world1(tree, batches)}
    torch.cuda.empty_cache()
    res["world2"] = _sp_world2(tree, tok, batches, res["world1"])
    torch.cuda.empty_cache()
    remat_batch = _batches(tok, split="train", batch_size=TRAIN_B,
                           seq_len=TRAIN_T, n=1)[0]
    res["remat_mu"] = _sp_remat_mu(tree, remat_batch)
    res["cli_remat_mu"] = _sp_cli_world1(tree)
    res["s"] = time.perf_counter() - t0
    log("sp:", json.dumps(res))
    return res


def sp_only() -> int:
    """Phase 25 alone after the build (``--sp``): the ``sp`` line, the
    card's line and the result line."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    from distributedtraining_tpu_torch.models import gpt2
    phase_build()
    tok = _tokenizer()
    tree = gpt2.init_params_numpy(gpt2.PRESETS["gpt2-124m"], SEED)
    res = phase_sp(tree, tok)
    print(json.dumps({"sp": {**res, "card": card}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# 26. llama: the Llama family on the serving path
# ---------------------------------------------------------------------------

LLAMA_PRESET = "llama3-8b"
# the drafter: GPT-2-124M's widths over the target's vocabulary
LLAMA_DRAFT_PRESET = "gpt2-124m"
# the paged kernels' Llama contexts: 8 slots at about phase 21's lengths
# (a 512-token system prompt, its suffixes, tokens decoded), a table of
# the engine's bucket for them (64 pages of 16)
LLAMA_DECODE_LENS = [520, 525, 531, 536, 542, 547, 553, 559]
LLAMA_MP = 64
LLAMA_NEW = 32
LLAMA_DRAFT_K = 4
# the server CLI's base: the shard set (32.12 GB) on a disk, and the
# monolithic file (32.12 GB, past the read cap: only its hash is read) in
# RAM under LLAMA_SHM, since the card's machine takes 45 GiB of disk writes
# a call; the host holds the tree and the RAM file while publishing
LLAMA_SHM = "/dev/shm"
LLAMA_DISK_BYTES = 35 * 10**9
LLAMA_SHM_BYTES = 33 * 10**9
LLAMA_HOST_BYTES = 70 * 10**9
LLAMA_CLI_TIMEOUT_S = 900.0


def _llama_cfg(**kw):
    from distributedtraining_tpu_torch.models import llama
    return dataclasses.replace(llama.PRESETS[LLAMA_PRESET], **kw)


def _llama_share(cfg) -> float:
    """``cfg``'s parameters over the whole preset's (counted on the meta
    device): the share of the preset's base a cut depth publishes."""
    import torch
    from distributedtraining_tpu_torch.models import llama

    def count(c) -> int:
        with torch.device("meta"):
            model, _ = llama.make_model(c)
        return sum(v.numel() for v in model.state_dict().values())
    return count(cfg) / count(_llama_cfg())


def _drawn_state(cfg, seed: int) -> dict:
    """A state dict of ``cfg``'s family drawn on the card from a seeded
    ``torch.Generator``, in the JAX init's distributions: norm scales 1,
    biases 0, GPT-2's ``wpe`` normal 0.01, every other leaf normal 0.02,
    in the storage dtype."""
    import torch
    from distributedtraining_tpu_torch import models
    g = torch.Generator(device=DEV).manual_seed(seed)
    out = {}
    for name, p in models.make_model(cfg)[0].state_dict().items():
        if name.endswith(".scale"):
            t = torch.ones(p.shape, dtype=p.dtype, device=DEV)
        elif name.endswith(".bias"):
            t = torch.zeros(p.shape, dtype=p.dtype, device=DEV)
        else:
            std = 0.01 if name == "wpe" else 0.02
            t = torch.randn(p.shape, generator=g, dtype=torch.float32,
                            device=DEV).mul_(std).to(p.dtype)
        out[name] = t
    return out


def _timings(fn, plain, lib, bound) -> dict:
    """A kernel call's ``_time_ms`` and profiler device ms beside its
    plain version's, the library call's and the bound."""
    return {"ms": _time_ms(fn), "device_ms": _device_ms(fn),
            "plain_ms": _time_ms(plain), "library_ms": _time_ms(lib),
            "library_device_ms": _device_ms(lib), "bound_ms": bound[0],
            "bound_by": bound[1]}


def _llama_flash_case(B, T, H, D, seg, dtype, seed):
    """q, k, v as a Llama's prefill makes them (contiguous q; k and v
    with their kv heads repeated to the query heads) and int32 ids."""
    import torch
    cfg = _llama_cfg()
    g = torch.Generator().manual_seed(seed)
    rep = cfg.n_head // cfg.n_kv_head
    q = torch.randn((B, T, H, D), generator=g)
    k, v = (torch.randn((B, T, H // rep, D), generator=g)
            .repeat_interleave(rep, dim=2) for _ in range(2))
    st = torch.from_numpy(seg.copy()).to(DEV, torch.int32)
    return (q.to(DEV, dtype), k.to(DEV, dtype), v.to(DEV, dtype), st)


def _masked_sdpa(q, k, v, st):
    """SDPA with the flash kernel's mask (causal, same segment) as a
    boolean mask: one library call for the same function."""
    import torch
    T = q.shape[1]
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    mask = (causal[None] & (st[:, :, None] == st[:, None, :]))[:, None]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kt, vt, attn_mask=mask)


def _llama_kernels(tok) -> dict:
    """26a: the paged decode, window and flash forward kernels at
    Llama-3-8B's heads (32 query heads over 8 kv heads, D 128) against
    their plain versions, in f32 (1e-5) and bf16 (2e-2; the window also
    within its per-element limit), then timed in bf16."""
    import numpy as np
    import torch
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import paged_attention as pa
    cfg = _llama_cfg()
    Hq, Hkv, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    tols = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    checks = []
    for dtype, tol in tols.items():
        dt = str(dtype).split(".")[1]
        args = _decode_case(8, Hq, Hkv, D, 16, LLAMA_MP, LLAMA_DECODE_LENS,
                            dtype, SEED + 26)
        out = pa.paged_decode_attention(*args)
        ref = pa.paged_decode_reference(*args)
        split = pa.paged_decode_split_reference(*args)
        checks.append({"kernel": "paged_decode_attention", "dtype": dt,
                       "tol": tol, "max_abs_err": _max_err(out, ref),
                       "max_abs_err_split": _max_err(out, split),
                       "finite": bool(torch.isfinite(out).all())})
        for name, (B, W, lens) in {
                "verify_w5": (8, 1 + LLAMA_DRAFT_K, LLAMA_DECODE_LENS),
                "suffix_w64_ctx512": (1, 64, [512])}.items():
            wargs = _window_case(B, W, lens, dtype, SEED + 27, Hq=Hq,
                                 Hkv=Hkv, D=D, MP=LLAMA_MP)
            out = pa.paged_window_attention(*wargs)
            f32 = [a.float() if a.is_floating_point() else a for a in wargs]
            ref = pa.paged_decode_reference(*f32)
            split = pa.paged_window_split_reference(*wargs)
            row = {"kernel": "paged_window_attention", "shape": name,
                   "dtype": dt, "tol": tol, "max_abs_err": _max_err(out, ref),
                   "max_abs_err_split": _max_err(out, split),
                   "finite": bool(torch.isfinite(out).all())}
            if dtype == torch.bfloat16:
                row["limit_ratio"] = _window_bf16_ratio(out, ref)
                row["limit_ratio_split"] = _window_bf16_ratio(out, split)
            checks.append(row)
    segs = _llama_flash_segs(tok)
    for name, seg in segs.items():
        B, T = seg.shape
        for dtype, tol in tols.items():
            q, k, v, st = _llama_flash_case(B, T, Hq, D, seg, dtype,
                                            SEED + 28)
            o, lse = fa.flash_attention_fwd(q, k, v, st)
            ref_o, ref_lse = fa.flash_attention_reference(
                q.float(), k.float(), v.float(), st)
            scaled = dtype == torch.bfloat16
            checks.append({
                "kernel": "flash_attention_fwd", "shape": name,
                "dtype": str(dtype).split(".")[1], "tol": tol,
                "max_abs_err": max(_max_err(o, ref_o, scaled),
                                   _max_err(lse, ref_lse, scaled)),
                "finite": bool(torch.isfinite(o).all()
                               and torch.isfinite(lse).all())})
            del q, k, v, o, lse, ref_o, ref_lse
    torch.cuda.synchronize()
    log("llama kernels:", json.dumps(checks))
    for c in checks:
        at = f"{c['kernel']} {c.get('shape', '')} {c['dtype']} (Llama heads)"
        check(c["finite"], f"{at}: non-finite output")
        check(c["max_abs_err"] <= c["tol"],
              f"{at}: max err {c['max_abs_err']} > {c['tol']}")
        if "max_abs_err_split" in c:
            check(c["max_abs_err_split"] <= c["tol"],
                  f"{at}: against the plain split version "
                  f"{c['max_abs_err_split']} > {c['tol']}")
        for key in ("limit_ratio", "limit_ratio_split"):
            if key in c:
                check(c[key] <= 1.0, f"{at}: {key} {c[key]}")
    # timed in bf16, the served dtype
    bf = torch.bfloat16
    timed = {}
    args = _decode_case(8, Hq, Hkv, D, 16, LLAMA_MP, LLAMA_DECODE_LENS, bf,
                        SEED + 26)
    timed["paged_decode_attention"] = {
        "shape": f"B 8, Hq {Hq}, Hkv {Hkv}, D {D}, P 16, MP {LLAMA_MP}, "
                 f"contexts {LLAMA_DECODE_LENS[0]}-{LLAMA_DECODE_LENS[-1]}",
        **_timings(lambda: pa.paged_decode_attention(*args),
                   lambda: pa.paged_decode_reference(*args),
                   _library_call(args), _bound(args, 2))}
    for name, (B, W, lens) in {
            "verify_w5": (8, 1 + LLAMA_DRAFT_K, LLAMA_DECODE_LENS),
            "suffix_w64_ctx512": (1, 64, [512])}.items():
        wargs = _window_case(B, W, lens, bf, SEED + 27, Hq=Hq, Hkv=Hkv, D=D,
                             MP=LLAMA_MP)
        timed[f"paged_window_attention_{name}"] = _timings(
            lambda: pa.paged_window_attention(*wargs),
            lambda: pa.paged_decode_reference(*wargs),
            _window_library(wargs), _window_bound(wargs, 2))
    for name, seg in segs.items():
        B, T = seg.shape
        q, k, v, st = _llama_flash_case(B, T, Hq, D, seg, bf, SEED + 28)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        timed[f"flash_attention_fwd_{name}"] = {
            **_timings(lambda: fa.flash_attention_fwd(q, k, v, st),
                       lambda: fa.flash_attention_reference(q, k, v, st),
                       _masked_sdpa(q, k, v, st),
                       _flash_bounds(B, T, Hq, D, seg, 2)[
                           "flash_attention_fwd"]),
            # SDPA's flash route: every causal pair, no ids
            "library_causal_ms": _time_ms(lambda: sdpa(qt, kt, vt,
                                                       is_causal=True))}
        del q, k, v, st, qt, kt, vt
    torch.cuda.empty_cache()
    res = {"checks": checks, "timed": timed, "timed_dtype": "bfloat16",
           "flash_shapes": {n: list(s.shape) for n, s in segs.items()},
           "clocks": _smi_clocks()}
    log("llama kernel timings:", json.dumps(timed))
    return res


def _llama_flash_segs(tok) -> dict:
    """The flash forward's Llama shapes: the main path's full prefill of
    phase 21's first request (515 prompt rows in a 1024-row bucket, the
    padding segment 0), a 576-token prompt whole, and a real packed
    batch of 8 x 512."""
    import numpy as np
    return {
        "prefill_b1_t1024_n515": (np.arange(1024)[None, :] < 515).astype(
            np.int32),
        "b1_t576": np.ones((1, 576), np.int32),
        "packed_b8_t512": np.ascontiguousarray(_batches(
            tok, split="train", batch_size=8, seq_len=512,
            n=1)[0]["segment_ids"]).astype(np.int32)}


def _llama_f32(tok) -> dict:
    """26b: Llama-3-8B's widths at 2 layers in f32 (TF32 off): the
    engine's greedy tokens equal ``reference_generate``'s and its pool
    holds 8 kv heads; then the f32 prefill/decode pair against the
    unified engine on phase 21's traffic (``_disagg_parity``)."""
    import torch
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.engine.serve import (
        GenerationEngine, reference_generate)
    cfg = _llama_cfg(n_layer=2, dtype="float32")
    model, _ = models.make_model(cfg)
    state = _drawn_state(cfg, SEED + 1)
    prompts = _prompts((5, 16, 17, 200), cfg.vocab_size, SEED + 1)
    eng = GenerationEngine(model, state, device=DEV, max_slots=4,
                           page_size=16)
    try:
        t0 = time.perf_counter()
        out = eng.generate(prompts, 16)
        eng_s = time.perf_counter() - t0
        pool = list(eng._kv[0].shape)
    finally:
        eng.close()
    t0 = time.perf_counter()
    refs = [reference_generate(model, state, p, 16) for p in prompts]
    ref_s = time.perf_counter() - t0
    check(out == refs, f"llama f32 engine output differs from "
                       f"reference_generate: {out} vs {refs}")
    check(pool[3] == cfg.n_kv_head,
          f"llama f32 pool {pool}: head axis is not n_kv_head")
    res = {"identity": {"prompts": [len(p) for p in prompts],
                        "new_tokens": 16, "token_identical": True,
                        "pool_shape": pool, "engine_s": eng_s,
                        "reference_s": ref_s,
                        "distinct_tokens": [len(set(o)) for o in out]}}
    s_prompts, lanes = _s6b_traffic(cfg.vocab_size)
    res["disagg_pair"] = _disagg_parity(cfg, state, s_prompts, lanes, DEV)
    del state
    torch.cuda.empty_cache()
    log("llama f32:", json.dumps(res))
    return res


def _hook_traces():
    """Keep every finished request trace's (ttft_ms, tpot_ms). Returns
    (list, undo)."""
    from distributedtraining_tpu_torch.utils import reqtrace
    real = reqtrace.TraceBook.finish
    seen: list = []

    def finish(book, req, status):
        tr = real(book, req, status)
        if tr is not None:
            seen.append((tr.ttft_ms, tr.tpot_ms))
        return tr
    reqtrace.TraceBook.finish = finish
    return seen, lambda: setattr(reqtrace.TraceBook, "finish", real)


def _drive(eng, bodies, **kw) -> list:
    """Every body submitted at once, the engine stepped until all are
    done (or prefilled on a prefill worker)."""
    reqs = [eng.submit(b["tokens"], b["max_new_tokens"],
                       temperature=b.get("temperature", 0.0),
                       top_p=b.get("top_p", 1.0), seed=b.get("seed", 0),
                       **(kw.get("per_req") or [{}] * len(bodies))[i])
            for i, b in enumerate(bodies)]
    while not all(r.done_evt.is_set() for r in reqs):
        eng.step()
    return reqs


def _llama_serving_want(cfg, eng, draft=None, dcfg=None) -> dict:
    """The launches a run must have made: n_layer x each dispatch kind
    of the target, and the drafter's n_layer x its steps and prefills."""
    L = cfg.n_layer
    dl = dcfg.n_layer if draft is not None else 0
    return {"paged_decode_attention": L * eng.decode_dispatches
            + (dl * draft.step_dispatches if draft else 0),
            "paged_window_attention": L * (eng.suffix_prefills
                                           + eng.verify_dispatches),
            "flash_attention_fwd": L * eng.full_prefills
            + (dl * draft.prefill_dispatches if draft else 0)}


def _llama_run(model, state, cfg, bodies, prompts, *, draft=None,
               dcfg=None, what: str) -> dict:
    """Phase 21's traffic through one engine (prefix cache on, 8 slots,
    page 16, the default pool) after a short warm-up request: every
    request done with its 32 tokens, prefix hits >= 7, launches exact,
    ttft and tpot from the request traces."""
    import torch
    from distributedtraining_tpu_torch.engine.serve import GenerationEngine
    launches = _s6b_launches()
    kw = dict(device=DEV, max_slots=8, page_size=16, prefix_cache=True,
              revision="seed0")
    if draft is not None:
        kw.update(draft=draft, draft_k=LLAMA_DRAFT_K)
    eng = GenerationEngine(model, state, **kw)
    seen, undo = _hook_traces()
    try:
        # cuBLAS and the allocator warm up off the measured run
        _drive(eng, [{"tokens": prompts[0][-4:], "max_new_tokens": 2}])
        for key in ("decode_dispatches", "verify_dispatches",
                    "full_prefills", "suffix_prefills", "tokens_emitted",
                    "spec_fallbacks", "_spec_proposed", "_spec_accepted"):
            setattr(eng, key, 0)
        if draft is not None:
            draft.step_dispatches = draft.prefill_dispatches = 0
        hits0 = eng.prefix_hits
        seen.clear()
        torch.cuda.reset_peak_memory_stats()
        launches(zero=True)
        t0 = time.perf_counter()
        reqs = _drive(eng, bodies)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launches()
        peak = torch.cuda.max_memory_allocated()
        for r in reqs:
            check(r.status == "done" and len(r.tokens) == LLAMA_NEW,
                  f"{what}: request {r.rid} {r.status} with "
                  f"{len(r.tokens)} tokens")
            check(all(0 <= x < cfg.vocab_size for x in r.tokens),
                  f"{what}: token outside the vocabulary")
        hits = eng.prefix_hits - hits0
        check(hits >= len(bodies) - 1, f"{what}: prefix hits {hits}")
        want = _llama_serving_want(cfg, eng, draft, dcfg)
        _check_launches(what, got, want)
        check(eng.full_prefills > 0 and eng.suffix_prefills > 0
              and eng.decode_dispatches + eng.verify_dispatches > 0,
              f"{what}: a kernel of the path never ran")
        res = {
            "wall_s": wall, "tokens": eng.tokens_emitted,
            "tokens_per_s": eng.tokens_emitted / wall,
            "ttft_ms_p50": _pct([a for a, _ in seen], 50),
            "ttft_ms_p95": _pct([a for a, _ in seen], 95),
            "tpot_ms_p50": _pct([b for _, b in seen], 50),
            "tpot_ms_p95": _pct([b for _, b in seen], 95),
            "prefix_hits": hits, "peak_cuda_mem_bytes": peak,
            "pool_shape": list(eng._kv[0].shape),
            "dispatches": {"decode": eng.decode_dispatches,
                           "verify": eng.verify_dispatches,
                           "full_prefill": eng.full_prefills,
                           "suffix_prefill": eng.suffix_prefills},
            "launches": got, "tokens_out": [r.tokens for r in reqs]}
        if draft is not None:
            check(eng._spec_proposed > 0 and eng.verify_dispatches > 0
                  and draft.step_dispatches > 0 and eng.spec_fallbacks == 0,
                  f"{what}: it did not draft (proposed "
                  f"{eng._spec_proposed}, verifies "
                  f"{eng.verify_dispatches}, drafter steps "
                  f"{draft.step_dispatches}, fallbacks "
                  f"{eng.spec_fallbacks})")
            res.update(accept_rate=eng.spec_accept_rate,
                       spec_proposed=eng._spec_proposed,
                       spec_fallbacks=eng.spec_fallbacks,
                       drafter_steps=draft.step_dispatches,
                       drafter_prefills=draft.prefill_dispatches)
        else:
            # a steady decode step's device time: the 8 requests again
            # (prefix hits), admitted, then profiled
            for b in bodies:
                eng.submit(b["tokens"], LLAMA_NEW)
            for _ in range(3):
                eng.step()
            check(eng.active_count == len(bodies),
                  f"{what}: profile batch not full")
            res["decode_profile"] = _profile_steps(eng, 6, "paged_decode")
    finally:
        undo()
        eng.close()
    return res


def _llama_disagg(model, state, cfg, bodies, work: str) -> dict:
    """26e: a prefill and a decode engine sharing the one placed weight
    set (install_params copies no tensor already on the card), the
    Llama pages over a LocalFS transport: every request adopted with no
    re-prefill, each worker's launches exact, the bytes moved."""
    import torch
    from distributedtraining_tpu_torch.engine import kv_transfer as kvt
    from distributedtraining_tpu_torch.engine.serve import GenerationEngine
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    launches = _s6b_launches()
    root = os.path.join(work, "kv")
    tr = LocalFSTransport(root)
    kw = dict(device=DEV, max_slots=8, page_size=16, prefix_cache=True,
              revision="seed0")
    pre = GenerationEngine(model, state, phase="prefill",
                           kv_exporter=kvt.KVExporter(tr), **kw)
    dec = GenerationEngine(model, state, phase="decode",
                           kv_adopter=kvt.KVAdopter(tr), **kw)
    try:
        for name, t in state.items():
            for e in (pre, dec):
                check(e.model.get_parameter(name).data_ptr()
                      == t.data_ptr(),
                      f"llama disagg: {name} was copied at install")
        launches(zero=True)
        t0 = time.perf_counter()
        legs = _drive(pre, bodies, per_req=[
            {"request_id": f"rq-llama-{i}"} for i in range(len(bodies))])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        got_pre = launches()
        launches(zero=True)
        t0 = time.perf_counter()
        outs = _drive(dec, bodies, per_req=[
            {"kv_ref": r.kv_ref, "first_token": r.first_token}
            for r in legs])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        got_dec = launches()
        n = len(bodies)
        check((pre.kv_exported, dec.kv_adopted, dec.kv_reprefills,
               dec.kv_rev_mismatch) == (n, n, 0, 0),
              f"llama disagg: exported {pre.kv_exported}, adopted "
              f"{dec.kv_adopted}, re-prefills {dec.kv_reprefills}, skews "
              f"{dec.kv_rev_mismatch} of {n}")
        check(all(r.status == "done" and len(r.tokens) == LLAMA_NEW
                  for r in outs), "llama disagg: a request not done")
        check(dec.full_prefills == dec.suffix_prefills == 0
              and pre.decode_dispatches == 0,
              "llama disagg: a worker ran the other's phase")
        L = cfg.n_layer
        _check_launches("llama prefill worker", got_pre, {
            "flash_attention_fwd": L * pre.full_prefills,
            "paged_window_attention": L * pre.suffix_prefills})
        _check_launches("llama decode worker", got_dec, {
            "paged_decode_attention": L * dec.decode_dispatches})
        kv_dir = os.path.join(root, "deltas")
        sizes = [os.path.getsize(os.path.join(kv_dir, f))
                 for f in os.listdir(kv_dir) if f.startswith("__kv__.s.")]
        res = {"requests": n, "adopted": dec.kv_adopted,
               "reprefills": dec.kv_reprefills,
               "prefill_leg_s": prefill_s, "decode_leg_s": decode_s,
               "pages_published": len(sizes), "page_bytes": sum(sizes),
               "page_bytes_each": max(sizes) if sizes else 0,
               "launches_prefill": got_pre, "launches_decode": got_dec,
               "dispatches": {"full_prefill": pre.full_prefills,
                              "suffix_prefill": pre.suffix_prefills,
                              "decode": dec.decode_dispatches},
               "weights_shared": True}
    finally:
        pre.close()
        dec.close()
    return res


def _fs_of(path: str) -> str:
    """The filesystem type /proc/mounts gives the mount holding ``path``."""
    path = os.path.realpath(path)
    best, fstype = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt = parts[1].replace("\\040", " ")
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best):
                best, fstype = mnt, parts[2]
    return fstype


def _host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def _llama_disk(share: float = 1.0) -> dict:
    """Where the server CLI's root goes: the shard set in the first of
    the temporary directory and the checkout that is on a disk (not
    tmpfs or ramfs) with LLAMA_DISK_BYTES free, the monolithic file in
    LLAMA_SHM. Prints each candidate's free bytes and filesystem and the
    host's available memory, then fails unless all suffice: no depth
    cut, no fallback. The three needs are the whole preset's; ``share``
    (a cut depth's parameters over the whole preset's) scales them to
    the base actually published."""
    import shutil
    import tempfile
    seen = []
    for d in (tempfile.gettempdir(), ROOT, LLAMA_SHM):
        seen.append({"dir": d, "free_bytes": shutil.disk_usage(d).free,
                     "fs": _fs_of(d)})
    avail = _host_available_bytes()
    need_disk, need_shm, need_host = (int(b * share) for b in (
        LLAMA_DISK_BYTES, LLAMA_SHM_BYTES, LLAMA_HOST_BYTES))
    print(json.dumps({"llama_host": {"candidates": seen,
                                     "mem_available_bytes": avail,
                                     "share": share,
                                     "need_disk_bytes": need_disk,
                                     "need_shm_bytes": need_shm,
                                     "need_host_bytes": need_host}}),
          flush=True)
    ok = [c for c in seen[:2] if c["fs"] not in ("tmpfs", "ramfs")
          and c["free_bytes"] >= need_disk]
    check(ok, f"llama server CLI: no disk with {need_disk} bytes "
              f"free for the 8B base's shard set: {seen}")
    check(seen[2]["free_bytes"] >= need_shm,
          f"llama server CLI: {LLAMA_SHM} has {seen[2]['free_bytes']} "
          f"bytes free, {need_shm} needed for the monolithic file")
    check(avail >= need_host,
          f"llama server CLI: {avail} bytes of host memory available, "
          f"{need_host} needed to publish the 8B base")
    return {**ok[0], "candidates": seen, "mem_available_bytes": avail}


def _llama_cli(tree, cfg, bodies, disk: dict) -> dict:
    """26f: the server CLI with ``--model llama3-8b`` (the JAX server's
    defaults; only the corpus, tokenizer, port, a 1 s swap poll and a
    step bound given) over a LocalFS root on ``disk`` whose base the
    port published: the monolithic file (the revision is its hash; at
    32.12 GB it is past the 8 GiB read cap, so no fetcher can read it;
    its directory is a link into LLAMA_SHM), then the shard set and
    manifest on the disk (BasePublisher). Every request done
    on that revision, pulled through the manifest with no monolithic
    fallback, launches exact; the publish, pull and boot seconds."""
    import tempfile
    from distributedtraining_tpu_torch.engine import basedist
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    pulls: list = []
    real_fetch = basedist.BaseFetcher.fetch

    def fetch(f, *a, **kw):
        t0 = time.perf_counter()
        out = real_fetch(f, *a, **kw)
        pulls.append({"s": time.perf_counter() - t0,
                      "sharded": f.sharded_fetches_total,
                      "fallbacks": f.fallbacks_total,
                      "bytes": f.last_fetch_bytes, "ok": out is not None})
        return out

    with tempfile.TemporaryDirectory(dir=disk["dir"]) as work, \
            tempfile.TemporaryDirectory(dir=LLAMA_SHM) as ram:
        os.makedirs(os.path.join(work, "artifacts"))
        os.symlink(ram, os.path.join(work, "artifacts", "base"))
        t = LocalFSTransport(os.path.join(work, "artifacts"))
        t0 = time.perf_counter()
        rev = t.publish_base(tree)
        mono_s = time.perf_counter() - t0
        pub = basedist.BasePublisher(t)
        t0 = time.perf_counter()
        check(pub.publish_revision(tree, rev),
              "llama server CLI: the sharded publish failed")
        sharded_s = time.perf_counter() - t0
        tree.clear()
        gc.collect()
        mono_bytes = os.path.getsize(os.path.join(
            ram, "averaged_model.msgpack"))
        log(f"llama base published: monolithic {mono_bytes} B in "
            f"{mono_s:.1f} s, {pub.last_publish} in {sharded_s:.1f} s")
        port = _free_port()
        argv = ["--model", LLAMA_PRESET, "--work-dir", work, "--dataset",
                "synthetic", "--tokenizer", "word", "--serve-port",
                str(port), "--swap-poll", "1", "--max-steps", "100000"]
        basedist.BaseFetcher.fetch = fetch
        try:
            run = _server_cli(argv, port, bodies, None,
                              timeout=LLAMA_CLI_TIMEOUT_S)
        finally:
            basedist.BaseFetcher.fetch = real_fetch
    eng = run["engine"]
    for code, out in run["results"]:
        check(code == 200 and out["status"] == "done"
              and len(out["tokens"]) == LLAMA_NEW,
              f"llama server CLI: request not done: {code} {out}")
        check(out["revision"] == rev,
              f"llama server CLI: answered on {out['revision']}, not the "
              f"boot base {rev}")
    check(pulls and pulls[0]["ok"] and pulls[0]["sharded"] == 1
          and all(p["fallbacks"] == 0 for p in pulls),
          f"llama server CLI: the boot pull was not sharded: {pulls}")
    check(eng.prefix_hits >= len(bodies) - 1,
          f"llama server CLI: prefix hits {eng.prefix_hits}")
    want = _llama_serving_want(cfg, eng)
    _check_launches("llama server CLI", run["launches"], want)
    check(eng.decode_dispatches > 0 and eng.suffix_prefills > 0
          and eng.full_prefills > 0,
          "llama server CLI: a kernel of the path never ran")
    ttft = [a for a, _ in run["traces"]]
    tpot = [b for _, b in run["traces"]]
    return {"argv": argv, "rc": run["rc"], "revision": rev,
            "disk": {k: disk[k] for k in ("dir", "fs", "free_bytes")},
            "monolithic_dir": LLAMA_SHM,
            "monolithic_bytes": mono_bytes,
            "shards": pub.last_publish, "monolithic_publish_s": mono_s,
            "sharded_publish_s": sharded_s, "pulls": pulls,
            "boot_s": run["boot_s"], "wall_s": run["wall_s"],
            "tokens_per_s": run["tokens_in_wall"] / run["wall_s"],
            "ttft_ms_p50": _pct(ttft, 50), "tpot_ms_p50": _pct(tpot, 50),
            "prefix_hits": eng.prefix_hits,
            "dispatches": {"decode": eng.decode_dispatches,
                           "full_prefill": eng.full_prefills,
                           "suffix_prefill": eng.suffix_prefills},
            "launches": run["launches"]}


class LlamaCli:
    """26f in a child process (``--llama-cli OUT [N_LAYER]``), started
    before the phases it overlaps (22-25 in the whole script): its 8B
    base's publish and pull are host and disk work (~400 s on the card's
    machine at full depth), and its kernel launches count in its own
    process. The child draws the same seeded weights as this process's
    engines; it holds the card only while its server loads and serves,
    so the in-process 8B steps wait for it (:meth:`join`). ``layers``
    cuts its depth; with ``train`` 27b-e run first in a child of their
    own (``--llama-train-child OUT``), 26f's child starts when it ends,
    and :meth:`join` waits for both (``train_result`` holds 27b-e's
    result); with ``lora`` 28a-b run in a child of their own
    (``--lora-child OUT``) between the two (``lora_result``); with
    ``convert`` phase 29 runs in one more child (``--convert-child
    OUT``), started at once beside the chain (``convert_result``),
    phase 30 after it (``--health-child OUT``, ``health_result``) and
    phase 31 after that (``--obs-child OUT``, ``obs_result``)."""

    def __init__(self, layers: int | None = None, train: bool = False,
                 lora: bool = False, convert: bool = False):
        import shlex
        import tempfile
        self.tmp = tempfile.mkdtemp()
        self.out = os.path.join(self.tmp, "cli.json")
        self.train_out = os.path.join(self.tmp, "train.json") if train \
            else None
        self.train_result = None
        self.lora_out = os.path.join(self.tmp, "lora.json") if lora \
            else None
        self.lora_result = None
        self.log = open(os.path.join(self.tmp, "cli.log"), "w")
        self.t0 = time.perf_counter()
        me = [sys.executable, os.path.abspath(__file__)]
        cmds = [me + ["--llama-cli", self.out]
                + ([str(layers)] if layers else [])]
        if lora:
            # after 27b-e, so that the two trainings' peaks never meet
            cmds.insert(0, me + ["--lora-child", self.lora_out])
        if train:
            # first, so that its miner (the largest peak of the card's
            # memory, ~65 GB) meets phase 22's light serving and not the
            # mesh phases' worlds
            cmds.insert(0, me + ["--llama-train-child", self.train_out])
        self.proc = subprocess.Popen(
            ["/bin/sh", "-c", " && ".join(shlex.join(c) for c in cmds)],
            stdout=self.log, stderr=subprocess.STDOUT, cwd=ROOT)
        self.convert_out = self.convert_proc = None
        self.convert_result = self.health_result = self.obs_result = None
        if convert:
            self.convert_out = os.path.join(self.tmp, "convert.json")
            self.health_out = os.path.join(self.tmp, "health.json")
            self.obs_out = os.path.join(self.tmp, "obs.json")
            self.convert_log = open(os.path.join(self.tmp, "convert.log"),
                                    "w")
            # phase 30 after phase 29, and 31 after 30: their role
            # processes (at most three at once) meet the chain's
            # children, never each other's
            self.convert_proc = subprocess.Popen(
                ["/bin/sh", "-c", " && ".join(shlex.join(c) for c in (
                    me + ["--convert-child", self.convert_out],
                    me + ["--health-child", self.health_out],
                    me + ["--obs-child", self.obs_out]))],
                stdout=self.convert_log, stderr=subprocess.STDOUT, cwd=ROOT)

    def _join_convert(self) -> None:
        t0 = time.perf_counter()
        rc = self.convert_proc.wait(timeout=CONVERT_TIMEOUT_S)
        waited = time.perf_counter() - t0
        with open(os.path.join(self.tmp, "convert.log")) as f:
            text = f.read()
        if rc:
            log(f"--- convert and health children (exit {rc}):\n"
                f"{text[-8000:]}")
        check(rc == 0, f"phase 29's, 30's or 31's child exited {rc}")
        with open(self.convert_out) as f:
            self.convert_result = {**json.load(f), "waited_s": waited}
        with open(self.health_out) as f:
            self.health_result = {**json.load(f), "waited_s": waited}
        with open(self.obs_out) as f:
            self.obs_result = {**json.load(f), "waited_s": waited}
        log("health and obs children:", "\n".join(
            ln for ln in text.splitlines()
            if ln.startswith(("health ", "health:", "obs ", "obs:")))
            [-20000:])

    def join(self) -> dict:
        """Wait for the children; the first's result with their seconds,
        and the seconds this process waited. A child that failed fails
        the phase, the log's tail logged first."""
        import shutil
        t0 = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=LLAMA_CLI_TIMEOUT_S)
            if self.convert_proc is not None:
                self._join_convert()
        finally:
            self.close()
        waited = time.perf_counter() - t0
        with open(os.path.join(self.tmp, "cli.log")) as f:
            text = f.read()
        host = [ln for ln in text.splitlines()
                if ln.startswith('{"llama_host"')]
        if host:
            print(host[0], flush=True)
        if rc:
            log(f"--- llama children (exit {rc}):\n{text[-8000:]}")
        check(rc == 0, f"llama server CLI or train child exited {rc}")
        with open(self.out) as f:
            res = json.load(f)
        if self.train_out is not None:
            with open(self.train_out) as f:
                self.train_result = json.load(f)
            log("llama train child:", "\n".join(
                ln for ln in text.splitlines()
                if ln.startswith("llama train"))[-20000:])
        if self.lora_out is not None:
            with open(self.lora_out) as f:
                self.lora_result = json.load(f)
            log("lora child:", "\n".join(
                ln for ln in text.splitlines()
                if ln.startswith("lora "))[-20000:])
        shutil.rmtree(self.tmp, ignore_errors=True)
        return {**res, "child_s": time.perf_counter() - self.t0,
                "waited_s": waited}

    def close(self) -> None:
        for proc in (self.proc, self.convert_proc):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        self.log.close()
        if self.convert_proc is not None:
            self.convert_log.close()


def llama_cli_child(out: str, n_layer: int | None = None) -> int:
    """``--llama-cli OUT [N_LAYER]``: 26f. Checks the disk and the host,
    draws the 8B weights on the card (seed SEED, as the parent's engines
    do), copies them to the host, frees the card, then ``_llama_cli``;
    its result as JSON in OUT. ``n_layer`` cuts the preset's depth in
    this process (the CLI builds the preset by name)."""
    phase_env()
    sys.path.insert(0, ROOT)
    import torch
    from distributedtraining_tpu_torch import models
    cfg = _llama_cfg(**({"n_layer": n_layer} if n_layer else {}))
    disk = _llama_disk(_llama_share(cfg))
    models.llama.PRESETS[LLAMA_PRESET] = cfg
    state = _drawn_state(cfg, SEED)
    t0 = time.perf_counter()
    tree = models.params_to_numpy(state)
    d2h_s = time.perf_counter() - t0
    del state
    gc.collect()
    torch.cuda.empty_cache()
    _, bodies = _serve6_traffic(cfg.vocab_size)
    res = _llama_cli(tree, cfg, bodies, disk)
    res.update(d2h_s=d2h_s, host=disk)
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def phase_llama(tok, cli: LlamaCli | None = None) -> dict:
    """Phase 26 (see the module docstring): 26f in the child ``cli``
    (started here when None), 26a-b, then, once the child is done,
    26c-e; ``times_s`` holds each step's seconds."""
    import tempfile
    import torch
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.engine import speculative as spec
    t0 = time.perf_counter()
    own_cli = cli is None
    cli = cli or LlamaCli()
    times: dict = {}

    def timed(name, fn, *a, **kw):
        t1 = time.perf_counter()
        out = None
        try:
            out = fn(*a, **kw)
            return out
        finally:
            times[name] = time.perf_counter() - t1
            log(f"llama step {name}: {times[name]:.1f} s")
            if isinstance(out, dict):
                log(f"llama {name}:", json.dumps(out, default=str)[:20000])

    try:
        res: dict = {"preset": LLAMA_PRESET, "times_s": times}
        if own_cli:
            res["kernels"] = timed("kernels", _llama_kernels, tok)
            res["f32"] = timed("f32", _llama_f32, tok)
        # a child started before this phase may still hold the card:
        # the kernels are timed after it ends
        res["cli"] = timed("cli_join", cli.join)
        if not own_cli:
            res["kernels"] = timed("kernels", _llama_kernels, tok)
            res["f32"] = timed("f32", _llama_f32, tok)
    finally:
        cli.close()
    cfg = _llama_cfg()
    model, _ = models.make_model(cfg)
    state = timed("draw", _drawn_state, cfg, SEED)
    res["n_params"] = sum(v.numel() for v in state.values())
    prompts, bodies = _serve6_traffic(cfg.vocab_size)
    res["engine"] = timed("engine", _llama_run, model, state, cfg, bodies,
                          prompts, what="llama engine")
    dcfg = dataclasses.replace(models.gpt2.PRESETS[LLAMA_DRAFT_PRESET],
                               vocab_size=cfg.vocab_size)
    draft = spec.DraftEngine(models.make_model(dcfg)[0],
                             _drawn_state(dcfg, SEED + 2), device=DEV,
                             max_slots=8, page_size=16)
    res["speculative"] = timed("speculative", _llama_run, model, state, cfg,
                               bodies, prompts, draft=draft, dcfg=dcfg,
                               what="llama speculative")
    del draft       # closed with its engine
    on = res["speculative"].pop("tokens_out")
    off = res["engine"].pop("tokens_out")
    pairs = [(x, y) for a, b in zip(on, off) for x, y in zip(a, b)]
    res["bf16_spec_agreement"] = sum(x == y for x, y in pairs) / len(pairs)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        res["disagg"] = timed("disagg", _llama_disagg, model, state, cfg,
                              bodies, work)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    res["s"] = time.perf_counter() - t0
    log("llama:", json.dumps(res))
    return res


def _llama_entries(entries: list, llama: dict) -> list:
    """The kernels line's paged decode, window and flash forward entries,
    each with phase 26's Llama-3-8B timings and the launches of its
    engine, speculative, disaggregated and server CLI runs."""
    timed = llama["kernels"]["timed"]
    runs = {"engine": llama["engine"]["launches"],
            "speculative": llama["speculative"]["launches"],
            "disagg": {**llama["disagg"]["launches_prefill"],
                       **{k: v for k, v in
                          llama["disagg"]["launches_decode"].items() if v}},
            "cli": llama["cli"]["launches"]}
    for e in entries:
        keys = [k for k in timed if k.startswith(e["name"])]
        if not keys:
            continue
        e["llama"] = {"timed": {k: timed[k] for k in keys},
                      **{f"launches_{r}": got[e["name"]]
                         for r, got in runs.items()}}
    return entries


PAGED_SRC = "distributedtraining_tpu_torch/csrc/paged_attention.cu"


def llama_only() -> int:
    """Phase 26 alone after the build (``--llama``): the kernels line of
    the three kernels it runs (their Llama readings only), the ``llama``
    line, the card's line and the result line."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    build = phase_build()
    res = phase_llama(_tokenizer())
    entries = [{"name": name, "route": "cuda", "source": source,
                "build_s": build["build_s"]}
               for name, source in (
                   ("paged_decode_attention", PAGED_SRC),
                   ("paged_window_attention", PAGED_SRC),
                   ("flash_attention_fwd", FLASH_SOURCE))]
    print(json.dumps({"kernels": _llama_entries(entries, res)}), flush=True)
    print(json.dumps({"llama": {**res, "card": card}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# 27. llama-train: the Llama family on the miner, the validator and the
#     averager
# ---------------------------------------------------------------------------

# (b): Llama-3-8B's width at depth 2 (1,486,901,248 parameters); the
# miner's steps at B 4 x T 1024, the held-out batches at the same shape
LT_LAYERS = 2
LT_B, LT_T, LT_STEPS = 4, 1024, 4
LT_EVAL_BATCHES = 2
LT_META_EPOCHS = 2          # over one held-out batch: 2 meta-steps
LT_DENSITY = 1.0 / 64.0
# (a): the CE's rows at the miner's shape (a [4, 1025] batch's targets)
LT_CE_N = LT_B * LT_T
# (c): f32 at the 8B's width, depth 1
LT_F32_B, LT_F32_T, LT_F32_STEPS = 2, 256, 3
LT_F32_TOL = 1e-4
# (e): tiny-llama widened to E 256 (4 query over 2 kv heads of D 64), f32
LT_MESH_CFG = {"n_embd": 256, "intermediate_size": 512, "dtype": "float32"}
LT_MESH_B, LT_MESH_T, LT_MESH_STEPS = 4, 256, 3
LT_MESHES = {"fsdp2": {"fsdp": 2}, "tp2": {"tp": 2},
             "sp2": {"sp": 2}, "sp2_ring": {"sp": 2, "impl": "ring"}}
# (d): JAX tests/test_neurons.py::test_llama_family_offline_round's argv
LT_CLI_STEPS = 25
# the whole script's 26f child serves llama3-8b's width at this depth
# (9.42 GB of f32 weights: past the 8 GiB read cap, so the base still
# travels sharded); --llama runs it at full depth
LLAMA_CLI_LAYERS_MAIN = 6


def _lt_flash_case(B, T, seg, dtype, seed):
    """q, k, v as a Llama's training forward makes them (Llama-3-8B's
    heads, the kv heads repeated to the query heads), a cotangent and
    int32 ids."""
    import torch
    cfg = _llama_cfg()
    q, k, v, st = _llama_flash_case(B, T, cfg.n_head, cfg.head_dim, seg,
                                    dtype, seed)
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g).to(DEV, dtype)
    return q, k, v, do, st


def _lt_flash(tok) -> dict:
    """27a, flash: the forward and both backward kernels at Llama-3-8B's
    training shape ``[4, 1024, 32, 128]`` (bf16, a real packed batch's
    ids) and in f32 at T 256 against their plain versions, with the
    determinism check; then timed in bf16 beside the bound, the plain
    versions and SDPA with the same mask (and causal without ids)."""
    import torch
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    cfg = _llama_cfg()
    H, D = cfg.n_head, cfg.head_dim
    seg = _batches(tok, split="train", batch_size=LT_B, seq_len=LT_T,
                   n=1)[0]["segment_ids"].astype("int32")
    cases = {"train_b4_t1024_h32_d128": (LT_B, LT_T, torch.bfloat16),
             "f32_b2_t256_h32_d128": (2, 256, torch.float32)}
    checks = [_flash_check(name, *_lt_flash_case(B, T, seg[:B, :T], dt,
                                                 SEED + 27))
              for name, (B, T, dt) in cases.items()]
    torch.cuda.empty_cache()
    B, T = LT_B, LT_T
    q, k, v, do, st = _lt_flash_case(B, T, seg, torch.bfloat16, SEED + 28)
    o, lse = fa.flash_attention_fwd(q, k, v, st)
    di = fa._row_dot(o, do)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    causal = torch.ones((T, T), dtype=torch.bool, device=DEV).tril()
    mask = (causal[None] & (st[:, :, None] == st[:, None, :]))[:, None]
    out_m = sdpa(qt, kt, vt, attn_mask=mask)
    out_c = sdpa(qt, kt, vt, is_causal=True)

    def lib_bwd(out):
        return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                           retain_graph=True)

    fwd = {"flash_attention_fwd": lambda: fa.flash_attention_fwd(q, k, v,
                                                                 st),
           "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
               q, k, v, do, lse, di, st),
           "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
               q, k, v, do, lse, di, st)}
    # the plain forward, and the plain backward (dq, dk, dv in one call)
    # set beside each backward kernel; slow at this shape: fewer calls
    plain = {"fwd": _time_ms(lambda: fa.flash_attention_reference(
                 q, k, v, st), reps=5, warm=1),
             "bwd": _time_ms(lambda: fa.flash_attention_bwd_reference(
                 q, k, v, o, lse, do, st), reps=5, warm=1)}
    lib = {"fwd": lambda: sdpa(qt, kt, vt, attn_mask=mask),
           "bwd": lib_bwd(out_m)}
    lib_causal = {"fwd": lambda: sdpa(qt, kt, vt, is_causal=True),
                  "bwd": lib_bwd(out_c)}
    bounds = _flash_bounds(B, T, H, D, seg, 2)
    timed = {}
    for name, fn in fwd.items():
        side = "fwd" if name.endswith("fwd") else "bwd"
        timed[name] = {
            "ms": _time_ms(fn), "device_ms": _device_ms(fn),
            "plain_ms": plain[side], "library_ms": _time_ms(lib[side]),
            "library_causal_ms": _time_ms(lib_causal[side]),
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
    res = {"checks": checks, "timed": timed,
           "timed_shape": f"B {B}, T {T}, H {H}, D {D} bf16, a real "
                          "packed batch's ids; library: SDPA with the "
                          "same mask (fwd; its autograd backward for "
                          "dq, dk, dv in one call), causal without ids "
                          "beside it",
           "visible_pairs": _causal_pairs(B, T, H, seg)}
    del q, k, v, do, o, lse, di, qt, kt, vt, out_m, out_c, mask
    torch.cuda.empty_cache()
    return res


def _lt_ce_inputs(N, V, E, dtype, seed, labels=None, mask=None):
    """h, the head in ``dtype`` (drawn on the card: 525M values), int32
    labels and the per-token upstream gradient, as ``_ce_inputs``."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)
    h = torch.randn((N, E), generator=g, device=DEV).to(dtype)
    w = torch.randn((V, E), generator=g, device=DEV).mul_(0.02).to(dtype)
    if labels is None:
        y = torch.randint(0, V, (N,), generator=g, device=DEV,
                          dtype=torch.int32)
    else:
        y = torch.as_tensor(labels).reshape(-1).to(DEV, torch.int32)
    m = (torch.ones(N, device=DEV) if mask is None else
         torch.as_tensor(mask).reshape(-1).float().to(DEV))
    return h, w, y.contiguous(), (m / m.sum().clamp(min=1.0)).contiguous()


def _lt_ce(tok) -> dict:
    """27a, CE: the forward and the backward (dh and dW together and
    each alone) at Llama-3-8B's untied head (E 4096, V 128256) on the
    miner's 4096 rows in bf16 (a real batch's targets and mask) and on
    256 rows in f32, against their plain versions (the f32 kernels
    against ``_ce_plain_f64``, the f32 plain's own error reported) with
    ``_ce_check``'s limits (a planted wrong dh or dW must fail them);
    then timed in bf16 beside the bound, the plain versions and the
    library's path."""
    import torch
    from distributedtraining_tpu_torch.ops import fused_ce
    cfg = _llama_cfg()
    V, E = cfg.padded_vocab, cfg.n_embd
    batch = _batches(tok, split="train", batch_size=LT_B, seq_len=LT_T + 1,
                     n=1)[0]
    ids, msk = batch["input_ids"][:, 1:], batch["loss_mask"][:, 1:]
    bf = torch.bfloat16
    sms = _sms()
    cases = {"llama8b_n4096_bf16": (LT_CE_N, bf, dict(labels=ids,
                                                      mask=msk)),
             "llama8b_n256_f32": (256, torch.float32, {})}
    checks = []
    for i, (name, (n, dtype, kw)) in enumerate(cases.items()):
        h, w, y, g = _lt_ce_inputs(n, V, E, dtype, SEED + 40 + i, **kw)
        outs = _ce_run(h, w, y, g)
        dt = str(dtype).split(".")[1]
        case = {"case": name, "dtype": dt, "N": n, "V": V, "E": E,
                "tol": CE_TOL[dt]}
        if dtype == torch.float32:
            exact = _ce_plain_f64(h, w, y, g, want_dw=True)
            exact.update(dh_alone=exact["dh"], dw_alone=exact["dw"])
            case["plain_f32_vs_f64"] = {
                k: x for k, (_, x) in _ce_limit_errors(
                    {k: (r, exact[k]) for k, (_, r) in outs.items()},
                    dt).items()}
            outs = {k: (a, exact[k]) for k, (a, _) in outs.items()}
            del exact
        check(all(bool(torch.isfinite(a.float()).all())
                  for a, _ in outs.values()),
              f"fused CE kernels: non-finite output at {name}")
        errs = _ce_check(name, outs, dt)
        checks.append({**case,
                       "max_abs": {k: d for k, (d, _) in errs.items()},
                       "err": {k: x for k, (_, x) in errs.items()}})
        del outs, h, w, y, g
        torch.cuda.empty_cache()
    n = LT_CE_N
    h, w, y, g = _lt_ce_inputs(n, V, E, bf, SEED + 40, labels=ids, mask=msk)
    loss, m, s = fused_ce.fused_ce_fwd(h, w, y)
    runs = {"fused_ce_fwd": lambda: fused_ce.fused_ce_fwd(h, w, y),
            "fused_ce_bwd_dh": lambda: fused_ce.fused_ce_bwd_dh(
                h, w, y, m, s, g),
            "fused_ce_bwd_dw": lambda: fused_ce.fused_ce_bwd_dw(
                h, w, y, m, s, g),
            "fused_ce_bwd": lambda: fused_ce.fused_ce_bwd(h, w, y, m, s, g)}
    plain_fwd = _time_ms(lambda: fused_ce.fused_ce_fwd_reference(h, w, y),
                         reps=5, warm=1)
    plain_bwd = _time_ms(lambda: _ce_plain_bwd(h, w, y, m, s, g, bf),
                         reps=5, warm=1)
    hh, ww = h.detach().requires_grad_(), w.detach().requires_grad_()
    ce = torch.nn.functional.cross_entropy

    def lib_fwd():
        return ce((hh @ ww.T).float(), y.long(), reduction="none")

    out = lib_fwd()

    def lib_bwd():
        return torch.autograd.grad(out, (hh, ww), g, retain_graph=True)

    lib = {"fwd": _time_ms(lib_fwd), "bwd": _time_ms(lib_bwd)}
    bounds = _ce_bounds(n, V, E)
    timed = {}
    for name, fn in runs.items():
        side = "fwd" if name == "fused_ce_fwd" else "bwd"
        timed[name] = {
            "ms": _time_ms(fn),
            "plain_ms": plain_fwd if side == "fwd" else plain_bwd,
            "library_ms": lib[side],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
        # the profiler, one session a function: the forward and the
        # whole backward (a process loses its events after a few
        # sessions; dh and dW alone run the same kernels)
        if name in ("fused_ce_fwd", "fused_ce_bwd"):
            timed[name]["device_ms"] = _device_ms(fn)
        if side == "fwd":
            timed[name]["splits"] = fused_ce._fwd_splits(n, V, sms)
        else:
            timed[name]["plan"] = fused_ce._bwd_schedule(
                n, V, E, sms, **{"fused_ce_bwd_dh": dict(dw=False),
                                 "fused_ce_bwd_dw": dict(dh=False)}.get(
                                     name, {}))
    del h, w, hh, ww, out, m, s
    torch.cuda.empty_cache()
    return {"checks": checks, "timed": timed,
            "timed_shape": f"N {n}, V {V}, E {E}, bf16 h and head",
            "library": "cuBLAS bf16 GEMM to the logits (cast to f32) + "
                       "F.cross_entropy; backward: its autograd (dh and "
                       "dW in one call)",
            "plain": "the plain backward computes dh and dW in one call "
                     "(the chunked decomposition, the backward entry's "
                     "chunk)"}


def _lt_registers(build: dict) -> dict:
    """ptxas's registers and spills of the flash kernels' D 128
    instantiations (phase 2's report)."""
    kernels = build["sources"].get("flash_attention", {}).get("kernels", {})
    return {name: k for name, k in kernels.items()
            if "ILi128E" in name and "flash" in name}


def phase_llama_train_kernels(tok, build: dict) -> dict:
    """27a (see the module docstring): the six kernels of the Llama
    training path at Llama-3-8B's shapes against their plain versions,
    timed; the flash kernels' D 128 registers and spills."""
    import torch
    t0 = time.perf_counter()
    res = {"ce": _lt_ce(tok), "flash": _lt_flash(tok),
           "registers_d128": _lt_registers(build),
           "clocks": _smi_clocks()}
    torch.cuda.empty_cache()
    res["s"] = time.perf_counter() - t0
    log("llama train kernels:", json.dumps(res))
    return res


def _lt_step_hook(eng, rows: list):
    """Wrap ``eng.train_step``: each step's loss, wall ms (between two
    device synchronisations) and the peak of the card's memory so far
    into ``rows``."""
    import torch
    step = eng.train_step

    def wrapped(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        rows.append((float(out[1]["loss"]), (time.perf_counter() - t0) * 1e3,
                     torch.cuda.max_memory_allocated()))
        return out

    eng.train_step = wrapped


def _lt_launches() -> dict:
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    return {"dequant_scatter": dsc.launches, **fa.launches,
            **fused_ce.launches}


def _lt_zero() -> None:
    from distributedtraining_tpu_torch.ops import dequant_scatter as dsc
    _zero_counts()
    dsc.launches = 0


def _lt_free() -> None:
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _lt_miner(t, model, cfg, train) -> dict:
    """27b, the miner: a ``MinerLoop`` with ``--fused-loss``, remat on
    (the preset's) and ``--wire-v2`` int8 pulls the published base, takes
    ``LT_STEPS`` steps and pushes once."""
    import math
    import torch
    from distributedtraining_tpu_torch.engine.scheduler import FakeClock
    from distributedtraining_tpu_torch.engine.train import (MinerLoop,
                                                            TrainEngine)
    eng = TrainEngine(model, fused_loss=True, device=DEV)
    rows: list = []
    _lt_step_hook(eng, rows)
    miner = MinerLoop(eng, t, "hotkey_1", clock=FakeClock(),
                      send_interval=1e9, check_update_interval=1e9,
                      wire_v2=True, wire_quant="int8")
    _lt_free()
    torch.cuda.reset_peak_memory_stats()
    # main path: counts to 0 just before, read just after
    _lt_zero()
    t0 = time.perf_counter()
    miner.bootstrap()
    boot_s = time.perf_counter() - t0
    report = miner.run(iter(train))
    miner.flush()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = _lt_launches()
    peak = torch.cuda.max_memory_allocated()
    rows = list(rows)
    losses = [r[0] for r in rows]
    step_ms = [r[1] for r in rows]
    # one more step under the profiler (after the counts were read): its
    # device ms by kernel and idle share; None where the process's
    # profiler saw no device time
    try:
        prof, _ = _device_profile(lambda: eng.train_step(
            miner.state, eng.place_batch(train[0])), top=8)
    except SmokeFailure:
        prof = None
    miner.close()
    L, steps = cfg.n_layer, len(rows)
    check(steps == LT_STEPS and report.pushes == 1
          and report.pushes_failed == 0,
          f"llama miner: {steps} steps, pushes {report.pushes}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"llama miner losses {losses}")
    # remat recomputes each block's forward in the backward
    want = {"flash_attention_fwd": (2 if cfg.remat else 1) * L * steps,
            "flash_attention_bwd_dkv": L * steps,
            "flash_attention_bwd_dq": L * steps,
            "fused_ce_fwd": steps, "fused_ce_bwd_dh": steps,
            "fused_ce_bwd_dw": steps}
    _check_launches("llama miner", launches, want)
    del miner, eng
    _lt_free()
    return {"steps": steps, "losses": losses, "step_ms": step_ms,
            "step_ms_p50": statistics.median(step_ms),
            "tokens_per_s": LT_B * LT_T / statistics.median(step_ms) * 1e3,
            "bootstrap_s": boot_s, "loop_s": loop_s,
            # the steps' peak apart from the whole run's (the push packs
            # the wire-v2 delta after the last step)
            "steps_peak_cuda_mem_bytes": max(r[2] for r in rows),
            "peak_cuda_mem_bytes": peak, "pushes": report.pushes,
            "remat": cfg.remat, "launches": launches,
            "step_profile": prof}


def _lt_submissions(t, shapes: dict, rev) -> None:
    """A second honest submission (packed int8 noise at 1e-5, as phase
    16's) and a hostile one (its ``wte`` scale 1e6: the screen's
    magnitude verdict)."""
    import torch
    from distributedtraining_tpu_torch import delta
    g = torch.Generator(device=DEV).manual_seed(SEED + 5)

    def noise():
        return {k: torch.randn(s, generator=g, device=DEV).mul_(1e-5)
                for k, s in shapes.items()}

    _publish_packed(t, "hotkey_2", noise(), rev, "int8")
    huge, _ = delta.pack_delta_v2(noise(), density=LT_DENSITY)
    huge["leaves"]["wte"]["scale"] = torch.tensor(1e6, device=DEV)
    _publish_tree(t, "hotkey_6", huge, rev, "int8")
    del huge
    _lt_free()


def _lt_validator(t, model, cfg, held, chain_dir: str) -> dict:
    """27b, the validator: one round at cohort 8 over the honest miner,
    the second honest submission and the hostile one, the base in slot
    0; the unfused f32 loss (JAX's cohort path)."""
    import numpy as np
    import torch
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.engine.validate import Validator
    eng = TrainEngine(model, device=DEV)
    v = Validator(eng, t, LocalChain(chain_dir, my_hotkey="hotkey_91"),
                  eval_batches=lambda: iter(held), cohort_size=8)
    _lt_free()
    torch.cuda.reset_peak_memory_stats()
    _lt_zero()
    t0 = time.perf_counter()
    v.bootstrap()
    boot_s = time.perf_counter() - t0
    results = {s.hotkey: s for s in v.validate_and_score()}
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = _lt_launches()
    peak = torch.cuda.max_memory_allocated()
    v.close()
    scored = sorted(h for h, s in results.items() if s.loss is not None)
    mag = float(np.float32(127.0) * np.float32(1e6))
    want_verdict = f"magnitude_exceeded({mag:.3e}>{1e3:.3e})"
    honest = results.get("hotkey_1")
    check(honest is not None and honest.reason == "ok"
          and honest.score > 0, f"llama validator: the miner {honest}")
    check(results["hotkey_6"].reason == want_verdict
          and results["hotkey_6"].score == 0.0,
          f"llama validator: the hostile {results['hotkey_6']} != "
          f"{want_verdict}")
    check(scored == ["hotkey_1", "hotkey_2"], f"llama validator scored "
                                              f"{scored}")
    n = cfg.n_layer * LT_EVAL_BATCHES * (len(scored) + 1)
    _check_launches("llama validator", launches,
                    {"flash_attention_fwd": n})
    res = {"scores": {h: results[h].score for h in scored},
           "losses": {h: results[h].loss for h in scored},
           "base_loss": v.base_loss, "hostile": results["hotkey_6"].reason,
           "bootstrap_s": boot_s, "round_s": round_s,
           "peak_cuda_mem_bytes": peak, "launches": launches}
    del v, eng
    _lt_free()
    return res


def _lt_weighted(t, model, cfg, held, chain_dir: str) -> dict:
    """27b, the weighted round: the packed submissions folded through the
    scatter kernel, the hostile one refused; the published base against
    base + sum w_i decode(d_i) by the plain versions on the CPU."""
    import torch
    from distributedtraining_tpu_torch import delta, models
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.average import (AveragerLoop,
                                                              WeightedAverage)
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    LocalChain(chain_dir, my_hotkey="hotkey_91").set_weights(
        {"hotkey_1": 0.6, "hotkey_2": 0.4, "hotkey_6": 0.3})
    eng = TrainEngine(model, device=DEV)
    loop = AveragerLoop(eng, t, LocalChain(chain_dir, my_hotkey="hotkey_95"),
                        WeightedAverage(), val_batches=lambda: iter(held),
                        publish_policy="always")
    secs: dict = {}
    kept: dict = {}
    _timed_calls(loop, "gather_deltas", secs, kept)
    _timed_calls(loop.strategy, "merge", secs)
    t0 = time.perf_counter()
    loop.bootstrap()
    boot_s = time.perf_counter() - t0
    rev = loop._base_revision
    base_before = {k: v.detach().cpu() for k, v in loop.base_params.items()}
    _lt_free()
    torch.cuda.reset_peak_memory_stats()
    _lt_zero()
    t0 = time.perf_counter()
    merged = loop.run_round()
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = _lt_launches()
    peak = torch.cuda.max_memory_allocated()
    ids, deltas = kept["gather_deltas"]
    weights = loop.strategy._weights_cache[1]
    packed = sum(1 for d in deltas if delta.is_packed_v2(d))
    check(merged and ids == ["hotkey_1", "hotkey_2"] and packed == 2,
          f"llama weighted round merged {ids} ({packed} packed, ok "
          f"{merged})")
    check(t.base_revision() not in (None, rev),
          "llama weighted round: no base published")
    _check_launches("llama weighted round", launches, {
        "dequant_scatter": packed,
        "flash_attention_fwd": cfg.n_layer * LT_EVAL_BATCHES})
    template = loop._host_template()
    loop.close()
    del loop, eng
    _lt_free()
    t0 = time.perf_counter()
    agg = delta.aggregate_deltas(base_before, deltas, weights)
    pub = models.params_from_numpy(t.fetch_base(template)[0], device="cpu")
    err = max(float((pub[k] - (base_before[k] + agg[k])).abs().max())
              for k in pub)
    plain_s = time.perf_counter() - t0
    check(err <= 1e-6, f"llama weighted round: published base vs plain "
                       f"merge max abs {err} > 1e-6")
    del agg, pub, base_before, deltas
    gc.collect()
    return {"accepted": ids, "weights": [float(w) for w in weights],
            "published_vs_plain_max_abs": err, "bootstrap_s": boot_s,
            "round_s": round_s, "ingest_s": secs["gather_deltas"],
            "merge_s": secs["merge"], "plain_check_s": plain_s,
            "peak_cuda_mem_bytes": peak, "launches": launches}


def _lt_param(t, model, cfg, held, chain_dir: str) -> dict:
    """27b, the default strategy: ``ParameterizedMerge`` of the two
    honest submissions (densified) over ``LT_META_EPOCHS`` meta-steps on
    one held-out batch, from the weighted round's base (the submissions
    are stale there: accepted, as the reference averager accepts them);
    the published base against the plain mixture at its logits."""
    import torch
    from distributedtraining_tpu_torch import delta, models
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.average import (
        AveragerLoop, ParameterizedMerge)
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    eng = TrainEngine(model, device=DEV)
    one = held[:1]
    loop = AveragerLoop(eng, t, LocalChain(chain_dir, my_hotkey="hotkey_96"),
                        ParameterizedMerge(model, meta_epochs=LT_META_EPOCHS),
                        val_batches=lambda: iter(one),
                        publish_policy="always", stale_deltas="accept")
    secs: dict = {}
    kept: dict = {}
    _timed_calls(loop, "gather_deltas", secs, kept)
    _timed_calls(loop.strategy, "merge", secs, kept)
    loop.bootstrap()
    rev = loop._base_revision
    base_before = {k: v.detach().cpu() for k, v in loop.base_params.items()}
    _lt_free()
    torch.cuda.reset_peak_memory_stats()
    _lt_zero()
    t0 = time.perf_counter()
    merged = loop.run_round()
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = _lt_launches()
    peak = torch.cuda.max_memory_allocated()
    ids, deltas = kept["gather_deltas"]
    _, w = kept["merge"]
    check(merged and ids == ["hotkey_1", "hotkey_2"],
          f"llama parameterized round merged {ids} (ok {merged})")
    check(t.base_revision() not in (None, rev),
          "llama parameterized round: no base published")
    check(all(bool(torch.isfinite(x).all()) for x in w.values()),
          "llama parameterized round: non-finite logits")
    steps = LT_META_EPOCHS * len(one)
    L = cfg.n_layer
    # the meta-steps' forward runs under autograd: remat recomputes it
    _check_launches("llama parameterized round", launches, {
        "flash_attention_fwd": (2 if cfg.remat else 1) * L * steps
        + L * len(one),
        "flash_attention_bwd_dkv": L * steps,
        "flash_attention_bwd_dq": L * steps})
    template = loop._host_template()
    epoch_losses = loop.strategy.last_epoch_losses
    loop.close()
    del loop, eng
    _lt_free()
    placed = [delta.place_delta(d, base_before) for d in deltas]
    norm = {k: torch.softmax(x.detach().cpu(), dim=0) for k, x in w.items()}
    plain = delta.per_tensor_weighted_merge(base_before, placed, norm)
    pub = models.params_from_numpy(t.fetch_base(template)[0], device="cpu")
    err = max(float((pub[k] - plain[k]).abs().max()) for k in pub)
    check(err <= 1e-6, f"llama parameterized round: published base vs the "
                       f"plain mixture max abs {err} > 1e-6")
    del placed, plain, pub, base_before, deltas
    gc.collect()
    return {"accepted": ids, "meta_steps": steps,
            "epoch_losses": epoch_losses,
            "published_vs_plain_max_abs": err, "round_s": round_s,
            "merge_s": secs["merge"], "peak_cuda_mem_bytes": peak,
            "launches": launches}


def _lt_roles(tok) -> dict:
    """27b (see the module docstring): Llama-3-8B's width at depth 2,
    weights drawn on the card from SEED, over an in-memory transport
    (the bytes of every artifact serialized and read back as over a
    wire) and a local chain: genesis, the miner, the validator, the
    weighted round, the parameterized round."""
    import tempfile
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.transport import InMemoryTransport
    cfg = _llama_cfg(n_layer=LT_LAYERS)
    model = models.make_model(cfg)[0]
    train = _batches(tok, split="train", batch_size=LT_B, seq_len=LT_T,
                     n=LT_STEPS)
    held = _batches(tok, split="test", batch_size=LT_B, seq_len=LT_T,
                    n=LT_EVAL_BATCHES)
    state = _drawn_state(cfg, SEED)
    shapes = {k: v.shape for k, v in state.items()}
    res: dict = {"n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
                 "heads": [cfg.n_head, cfg.n_kv_head],
                 "intermediate_size": cfg.intermediate_size,
                 "padded_vocab": cfg.padded_vocab,
                 "n_params": sum(v.numel() for v in state.values()),
                 "batch": [LT_B, LT_T], "times_s": {}}
    tree = models.params_to_numpy(state)
    del state
    _lt_free()
    t = InMemoryTransport()
    t0 = time.perf_counter()
    rev0 = t.publish_base(tree)
    res["genesis_publish_s"] = time.perf_counter() - t0
    res["base_bytes"] = len(t.fetch_base_bytes())
    del tree
    gc.collect()
    with tempfile.TemporaryDirectory() as work:
        for name, fn, args in (
                ("miner", _lt_miner, (t, model, cfg, train)),
                ("submissions", _lt_submissions, (t, shapes, rev0)),
                ("validator", _lt_validator,
                 (t, model, cfg, held, os.path.join(work, "chain_val"))),
                ("weighted", _lt_weighted,
                 (t, model, cfg, held, os.path.join(work, "chain"))),
                ("parameterized", _lt_param,
                 (t, model, cfg, held, os.path.join(work, "chain")))):
            t0 = time.perf_counter()
            res[name] = fn(*args)
            res["times_s"][name] = time.perf_counter() - t0
            log(f"llama train step {name}: {res['times_s'][name]:.1f} s")
    res.pop("submissions")
    return res


def _lt_parity(tok) -> dict:
    """27c: Llama-3-8B's width at depth 1 in f32 (TF32 off), three steps
    each: the fused loss through the kernels, the unfused loss through
    the flash kernels, and the unfused loss with the attention forced to
    its plain versions (phase 9's test hook); the losses agree within
    ``LT_F32_TOL`` relative."""
    from unittest import mock
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    cfg = _llama_cfg(n_layer=1, dtype="float32")
    model = models.make_model(cfg)[0]
    batches = _batches(tok, split="train", batch_size=LT_F32_B,
                       seq_len=LT_F32_T, n=LT_F32_STEPS)
    state = _drawn_state(cfg, SEED + 3)

    def run(fused: bool):
        eng = TrainEngine(model, fused_loss=fused, device=DEV)
        st = eng.init_state(state)
        _zero_counts()
        losses = [float(eng.train_step(st, eng.place_batch(b))[1]["loss"])
                  for b in batches]
        launches = {**fa.launches, **fused_ce.launches}
        del eng, st
        _lt_free()
        return losses, launches

    fused_l, fused_n = run(True)
    unfused_l, unfused_n = run(False)
    with mock.patch.object(fa, "_forward", fa.flash_attention_reference), \
            mock.patch.object(fa, "_backward",
                              fa.flash_attention_bwd_reference):
        plain_l, plain_n = run(False)
    del state
    _lt_free()
    steps, L = len(batches), cfg.n_layer
    flash = {"flash_attention_fwd": (2 if cfg.remat else 1) * L * steps,
             "flash_attention_bwd_dkv": L * steps,
             "flash_attention_bwd_dq": L * steps}
    _check_launches("llama f32 fused", fused_n, {
        **flash, "fused_ce_fwd": steps, "fused_ce_bwd_dh": steps,
        "fused_ce_bwd_dw": steps})
    _check_launches("llama f32 unfused", unfused_n, flash)
    check(not any(plain_n.values()), f"llama f32 plain run launched "
                                     f"{plain_n}")

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    res = {"n_layer": L, "batch": [LT_F32_B, LT_F32_T], "fused": fused_l,
           "unfused": unfused_l, "unfused_plain_attention": plain_l,
           "fused_vs_unfused_rel": rel(fused_l, unfused_l),
           "kernels_vs_plain_rel": rel(unfused_l, plain_l),
           "tol": LT_F32_TOL}
    check(res["fused_vs_unfused_rel"] <= LT_F32_TOL
          and res["kernels_vs_plain_rel"] <= LT_F32_TOL,
          f"llama f32 parity: {res}")
    return res


def _lt_cli_argv(work: str, hotkey: str, extra: list) -> list:
    """JAX tests/test_neurons.py::test_llama_family_offline_round's
    argv."""
    return ["--backend", "local", "--work-dir", work, "--model",
            "tiny-llama", "--dataset", "synthetic", "--hotkey", hotkey,
            "--dp", "1", "--batch-size", "4", "--seq-len", "32",
            "--eval-seq-len", "32", "--eval-batches", "2", *extra]


def _lt_clis() -> dict:
    """27d: the miner, validator and averager CLIs on ``--model
    tiny-llama`` on the card with JAX's argv, over one LocalFS root
    whose base was published first: rc 0, one push, the validator's
    weight on the miner > 0, a new base published. The preset is widened
    to (e)'s E 256 in this process: its heads of D 16 are below the
    flash kernels' D 64 and 128, and the kernels refuse them."""
    from distributedtraining_tpu_torch import models
    preset = models.llama.PRESETS["tiny-llama"]
    models.llama.PRESETS["tiny-llama"] = dataclasses.replace(
        preset, **{k: v for k, v in LT_MESH_CFG.items() if k != "dtype"})
    try:
        return _lt_clis_run()
    finally:
        models.llama.PRESETS["tiny-llama"] = preset


def _lt_clis_run() -> dict:
    import tempfile
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.neurons import averager as avg_cli
    from distributedtraining_tpu_torch.neurons import miner as miner_cli
    from distributedtraining_tpu_torch.neurons import validator as val_cli
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    res: dict = {}
    with tempfile.TemporaryDirectory() as work:
        t = LocalFSTransport(os.path.join(work, "artifacts"))
        rev0 = t.publish_base(models.init_params_numpy(
            models.llama.PRESETS["tiny-llama"], SEED))
        runs = (("miner", miner_cli, "hotkey_0", [
                    "--max-steps", str(LT_CLI_STEPS), "--send-interval",
                    "1e9", "--checkpoint-interval", "0", "--delta-dtype",
                    "sparse8"]),
                ("validator", val_cli, "hotkey_91", ["--rounds", "1"]),
                ("averager", avg_cli, "hotkey_99",
                 ["--rounds", "1", "--strategy", "weighted"]))
        for name, cli, hotkey, extra in runs:
            argv = _lt_cli_argv(work, hotkey, extra)
            _zero_counts()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            res[name] = {"argv": argv, "rc": rc,
                         "s": time.perf_counter() - t0,
                         "launches": {**fa.launches, **fused_ce.launches}}
            check(rc == 0, f"llama {name} CLI exited {rc}")
            check(res[name]["launches"]["flash_attention_fwd"] > 0,
                  f"llama {name} CLI launched no flash kernel")
        check(t.fetch_delta_bytes("hotkey_0") is not None,
              "llama miner CLI pushed nothing")
        with open(os.path.join(work, "chain", "metagraph.json")) as f:
            weight = json.load(f)["weights"]["hotkey_91"].get("hotkey_0", 0)
        check(weight > 0, f"llama validator CLI weight on the miner "
                          f"{weight}")
        rev1 = t.base_revision()
        check(rev1 not in (None, rev0), "llama averager CLI published no "
                                        "base")
        res.update(validator_weight=weight, published=rev1 != rev0)
    return res


def _lt_mesh_batches(tok, tmp: str) -> None:
    """(e)'s global batches: packed rows of the corpus (ids folded into
    tiny-llama's vocabulary, the packing kept) and the same ids unpacked
    (the ring's), in ``tmp/lt_batches.npz``."""
    import numpy as np
    from distributedtraining_tpu_torch import models
    V = models.llama.PRESETS["tiny-llama"].vocab_size
    out = {}
    for i, b in enumerate(_batches(tok, split="train", batch_size=LT_MESH_B,
                                   seq_len=LT_MESH_T, n=LT_MESH_STEPS)):
        ids = (b["input_ids"] % V).astype(np.int32)
        out[f"plain/{i}/input_ids"] = ids
        for k in ("segment_ids", "position_ids", "loss_mask"):
            out[f"packed/{i}/{k}"] = b[k]
        out[f"packed/{i}/input_ids"] = ids
    np.savez(os.path.join(tmp, "lt_batches.npz"), **out)


def _lt_mesh_cfg(impl: str | None):
    from distributedtraining_tpu_torch import models
    return dataclasses.replace(models.llama.PRESETS["tiny-llama"],
                               **LT_MESH_CFG,
                               **({"attention_impl": impl} if impl else {}))


def _lt_mesh_run(name: str, axes: dict, batches: dict, mesh) -> dict:
    """One engine of (e): fused loss, ``LT_MESH_STEPS`` f32 steps on this
    rank's rows and positions (world 1: ``mesh`` None); the losses, the
    launches and the block routes of those steps."""
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.delta import flatten_tree
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.parallel import batch_rows, sharding
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    from distributedtraining_tpu_torch.ops import fused_ce
    cfg = _lt_mesh_cfg(axes.get("impl"))
    eng = TrainEngine(models.make_model(cfg)[0], fused_loss=True, mesh=mesh,
                      device=DEV)
    state = eng.init_state(flatten_tree(models.init_params_numpy(cfg,
                                                                 SEED)))
    rows = batches["plain" if axes.get("impl") == "ring" else "packed"]
    sharding.reset_counts()
    _zero_counts()
    losses = []
    for b in rows:
        if mesh is not None:
            b = batch_rows(b, mesh)
        state, m = eng.train_step(state, eng.place_batch(b))
        losses.append(float(m["loss"]))
    return {"losses": losses, "launches": {**fa.launches,
                                           **fused_ce.launches},
            "routes": {k: v for k, v in sharding.counts.items()
                       if k.startswith("tp_")},
            "tp_route": eng.tp_route}


def llama_train_worker(rank: int, port: int, tmp: str) -> int:
    """One rank of 27e's world of two over gloo on this card
    (``--llama-train-worker``): every mesh of ``LT_MESHES``; its results
    in ``tmp/out_<rank>.json``."""
    import torch
    from distributedtraining_tpu_torch.parallel import (Mesh, MeshConfig,
                                                        multihost)
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"127.0.0.1:{port}", 2, rank, device=DEV,
                         backend="gloo", timeout_s=PAR_TIMEOUT_S)
    out = {"rank": rank}
    try:
        batches = _sp_arrays_from(os.path.join(tmp, "lt_batches.npz"))
        for name, axes in LT_MESHES.items():
            mesh = Mesh(MeshConfig(**_par_mesh_kw(axes)))
            out[name] = _lt_mesh_run(name, axes, batches, mesh)
    finally:
        multihost.shutdown()
    return _par_worker_done(tmp, rank, out)


def _lt_mesh(tok) -> dict:
    """27e: tiny-llama widened to E 256 (f32) on a world of two over
    gloo, both ranks on this card (``--llama-train-worker``): fsdp 2, tp
    2 (the kv heads split: head_split), sp 2 on packed rows (the
    gathered flash route) and on unpacked ones (the ring); each rank's
    losses within ``LT_F32_TOL`` of world 1's, its launches and block
    routes exact."""
    import tempfile
    cfg = _lt_mesh_cfg(None)
    L = cfg.n_layer
    res: dict = {"model": "tiny-llama", **LT_MESH_CFG,
                 "batch": [LT_MESH_B, LT_MESH_T], "steps": LT_MESH_STEPS}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _lt_mesh_batches(tok, tmp)
        batches = _sp_arrays_from(os.path.join(tmp, "lt_batches.npz"))
        w1 = {name: _lt_mesh_run(name, axes, batches, None)["losses"]
              for name, axes in LT_MESHES.items()}
        outs = _par_spawn(2, "gloo", {}, tmp, "llama train world 2",
                          mode="--llama-train-worker")
    for name, axes in LT_MESHES.items():
        tp = axes.get("tp", 1)
        route = (None if tp == 1 else "head_split"
                 if cfg.n_kv_head % tp == 0 else "gathered_attn")
        steps = LT_MESH_STEPS
        want = {"flash_attention_fwd": L * steps,
                "flash_attention_bwd_dkv": L * steps,
                "flash_attention_bwd_dq": L * steps,
                "fused_ce_fwd": steps, "fused_ce_bwd_dh": steps,
                "fused_ce_bwd_dw": steps}
        if axes.get("impl") == "ring":       # the ring runs no flash kernel
            want = {k: (0 if k.startswith("flash") else v)
                    for k, v in want.items()}
        for r, o in enumerate(outs):
            run = o[name]
            what = f"llama train world 2 {name} rank {r}"
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(run["losses"], w1[name]))
            check(rel <= LT_F32_TOL, f"{what}: losses {run['losses']} vs "
                                     f"world 1 {w1[name]} ({rel})")
            _check_launches(what, run["launches"], want)
            check(run["tp_route"] == route,
                  f"{what}: route {run['tp_route']} != {route}")
            want_r = {f"tp_{x}_blocks": L * steps if x == route else 0
                      for x in ("head_split", "gathered_attn")}
            check(run["routes"] == want_r,
                  f"{what}: routes {run['routes']} != {want_r}")
        res[name] = {"mesh": axes, "world1": w1[name],
                     "losses": [o[name]["losses"] for o in outs],
                     "launches": outs[0][name]["launches"],
                     "route": route}
    res["s"] = time.perf_counter() - t0
    return res


def llama_train_roles(tok) -> dict:
    """27b-e (see the module docstring), each step's seconds in
    ``times_s``."""
    t0 = time.perf_counter()
    res: dict = {"times_s": {}}
    for name, fn in (("roles", _lt_roles), ("f32", _lt_parity),
                     ("cli", lambda tok: _lt_clis()), ("mesh", _lt_mesh)):
        t1 = time.perf_counter()
        res[name] = fn(tok)
        res["times_s"][name] = time.perf_counter() - t1
        log(f"llama train {name}: {res['times_s'][name]:.1f} s",
            json.dumps(res[name], default=str)[:20000])
    res["s"] = time.perf_counter() - t0
    return res


def llama_train_child(out: str) -> int:
    """``--llama-train-child OUT``: 27b-e in a child process (before
    26f's, beside phases 22-25 in the whole script); its result as JSON
    in OUT."""
    phase_env()
    sys.path.insert(0, ROOT)
    res = llama_train_roles(_tokenizer())
    with open(out, "w") as f:
        json.dump(res, f, default=str)
    return 0


def _lt_entries(entries: list, kern: dict, roles: dict) -> list:
    """The kernels line's flash, CE and scatter entries, each with phase
    27's Llama-3-8B training readings (times at the training shape) and
    the launches of its role runs."""
    timed = {**kern["flash"]["timed"], **kern["ce"]["timed"]}
    runs = {r: roles["roles"][r]["launches"]
            for r in ("miner", "validator", "weighted", "parameterized")}
    for e in entries:
        if e["name"] not in timed and e["name"] != "dequant_scatter":
            continue
        # the backward entry counts one dh and one dW launch a call
        counter = ("fused_ce_bwd_dh" if e["name"] == "fused_ce_bwd"
                   else e["name"])
        e["llama_train"] = {
            **({"timed": timed[e["name"]]} if e["name"] in timed else {}),
            **{f"launches_{r}": got.get(counter, 0)
               for r, got in runs.items()}}
    return entries


def llama_train_only() -> int:
    """Phase 27 alone after the build (``--llama-train``): 27b-e, then
    27a, in this process; the kernels line of the seven kernels it
    runs (their Llama readings only), the ``llama_train`` line, the
    card's line and the result line."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    build = phase_build()
    tok = _tokenizer()
    # the roles first: the profiler's first session is the miner step's
    roles = llama_train_roles(tok)
    kern = phase_llama_train_kernels(tok, build)
    entries = [{"name": name, "route": "cuda", "source": source,
                "build_s": build["build_s"]}
               for name, source in (
                   ("flash_attention_fwd", FLASH_SOURCE),
                   ("flash_attention_bwd_dkv", FLASH_SOURCE),
                   ("flash_attention_bwd_dq", FLASH_SOURCE),
                   ("fused_ce_fwd", CE_SOURCE),
                   ("fused_ce_bwd_dh", CE_SOURCE),
                   ("fused_ce_bwd_dw", CE_SOURCE),
                   ("dequant_scatter", SCATTER_SOURCE))]
    print(json.dumps({"kernels": _lt_entries(entries, kern, roles)}),
          flush=True)
    print(json.dumps({"llama_train": {"kernels": kern, **roles,
                                      "card": card}}, default=str),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# 28. lora
# ---------------------------------------------------------------------------

LORA_RANK = 8               # --lora-rank (the README's); --lora-alpha 16
LORA_LR = 5e-3              # the LoRA miners' --learning-rate
LORA_FULL_LR = 1e-3         # the full-parameter miner's
# (a) and (b): one CLI round each: preset, depth (None: the preset's),
# --batch-size, --seq-len, --max-steps
LORA_ROUNDS = {"gpt2_124m": ("gpt2-124m", None, 8, 256, 4),
               "llama2_7b_d2": ("llama2-7b", 2, 4, 256, 4)}
LORA_EVAL = ["--eval-batches", "2", "--eval-seq-len", "256"]
LORA_DENSE_TOL = 1e-6       # host densify vs the card's, f32, TF32 off
# (c), --lora: llama2-7b at full width and depth
LORA_PRESET = "llama2-7b"
LORA_B, LORA_T, LORA_STEPS, LORA_HELD = 4, 1024, 6, 2
LORA_BIG_LR = 2e-3
# (d), --lora: a world of two on phase 27's widened tiny-llama
LORA_MESHES = {"dp2": {"dp": 2}, "fsdp2": {"fsdp": 2}, "sp2": {"sp": 2},
               "tp2": {"tp": 2}}


def _lora_sync() -> None:
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


class _LoraTap:
    """Class-level hooks on what the role CLIs build: each train step's
    loss (the LoRA step and the full one) and the hotkeys each averager
    round gathered."""

    def __enter__(self):
        from distributedtraining_tpu_torch.engine.average import \
            AveragerLoop
        from distributedtraining_tpu_torch.engine.lora_train import \
            LoRAEngine
        from distributedtraining_tpu_torch.engine.train import TrainEngine
        self.losses: list = []
        self.gathered: list = []
        self._undo = []
        tap = self

        def hook(cls, name, wrap):
            real = getattr(cls, name)
            setattr(cls, name, wrap(real))
            self._undo.append((cls, name, real))

        def lora_step(real):
            def step(eng, state, base, batch):
                out = real(eng, state, base, batch)
                tap.losses.append(float(out[1]["loss"]))
                return out
            return step

        def full_step(real):
            def step(eng, state, batch):
                out = real(eng, state, batch)
                tap.losses.append(float(out[1]["loss"]))
                return out
            return step

        def gather(real):
            def run(loop):
                ids, staged = real(loop)
                tap.gathered.append(list(ids))
                return ids, staged
            return run

        hook(LoRAEngine, "train_step", lora_step)
        hook(TrainEngine, "train_step", full_step)
        hook(AveragerLoop, "gather_deltas", gather)
        return self

    def __exit__(self, *exc):
        for cls, name, real in reversed(self._undo):
            setattr(cls, name, real)

    def take_losses(self) -> list:
        out, self.losses = self.losses, []
        return out


def _lora_cli(module, argv) -> dict:
    """One role CLI's ``main``, the launch counts set to 0 just before
    and read just after: its return code, seconds and launches."""
    _lora_sync()
    _lt_zero()
    t0 = time.perf_counter()
    rc = module.main(argv)
    _lora_sync()
    return {"argv": argv, "rc": rc, "s": time.perf_counter() - t0,
            "launches": _lt_launches()}


def _lora_argv(work: str, preset: str, hotkey: str, b: int, t: int,
               extra: list) -> list:
    return [*DEFAULT_FLAGS, "--backend", "local", "--work-dir", work,
            "--model", preset, "--hotkey", hotkey, "--no-base-wire-v2",
            "--flight-events", "0", "--batch-size", str(b), "--seq-len",
            str(t), *LORA_EVAL, *extra]


def _lora_work_root() -> str | None:
    """Where a round's LocalFS root goes: /dev/shm when it has room for
    a few copies of the largest round's base (a 9p disk reads ~0.3
    GB/s), else the default temporary directory."""
    try:
        st = os.statvfs(LLAMA_SHM)
    except OSError:
        return None
    return LLAMA_SHM if st.f_bavail * st.f_frsize > 20 * 10**9 else None


def _lora_base(cfg) -> dict:
    """The round's genesis base as a host tree: GPT-2's numpy init, a
    Llama's drawn on the card (``_drawn_state``) and copied to the
    host."""
    from distributedtraining_tpu_torch import models
    if models.family(cfg) is models.gpt2:
        return models.init_params_numpy(cfg, SEED)
    state = _drawn_state(cfg, SEED)
    tree = models.params_to_numpy(state)
    del state
    _lt_free()
    return tree


def _lora_densify(data: bytes, template, lcfg) -> dict:
    """One LoRA submission densified by the plain path on the host
    (``densify_delta_bytes``, numpy) against the card's
    ``lora_to_full_delta`` of the same adapters, kernel by kernel; the
    template is cut to the adapted kernels, so nothing else is built."""
    import numpy as np
    from distributedtraining_tpu_torch import serialization as ser
    from distributedtraining_tpu_torch.delta import flatten_tree, nest_tree
    from distributedtraining_tpu_torch.engine.ingest import \
        densify_delta_bytes
    from distributedtraining_tpu_torch.models import lora
    flat = flatten_tree(template)
    targets = lora.targets(flat, lcfg)
    sub = nest_tree({k: flat[k] for k in targets})
    t0 = time.perf_counter()
    host = densify_delta_bytes(data, sub, lcfg)
    host_s = time.perf_counter() - t0
    check(host is not None, "a LoRA submission did not densify")
    host = flatten_tree(host)
    check(set(host) == set(targets),
          f"densified {len(host)} kernels, {len(targets)} adapted")
    adapters = lora.adapters_from_numpy(
        ser.validated_load(data, lora.adapter_template(sub, lcfg)),
        device=DEV)
    err = peak = 0.0
    for k in targets:
        card = lora.kernel_delta(adapters, k, lcfg).cpu().numpy()
        err = max(err, float(np.max(np.abs(card - host[k]))))
        peak = max(peak, float(np.max(np.abs(host[k]))))
    check(peak > 0, "the LoRA submission's delta is zero")
    check(err <= LORA_DENSE_TOL,
          f"host densify vs the card's: max abs {err} > {LORA_DENSE_TOL}")
    return {"kernels": len(targets), "max_abs_err": err,
            "max_abs": peak, "host_s": host_s}


def _lora_round(name: str) -> dict:
    """28a/b (see the module docstring): one CLI round on one LocalFS
    root at ``LORA_ROUNDS[name]``."""
    import tempfile
    from distributedtraining_tpu_torch import models
    preset, depth, b, t, steps = LORA_ROUNDS[name]
    fam = models.family(preset)
    cfg0 = fam.PRESETS[preset]
    cfg = dataclasses.replace(cfg0, n_layer=depth) if depth else cfg0
    fam.PRESETS[preset] = cfg        # the CLIs build the preset by name
    try:
        with tempfile.TemporaryDirectory(dir=_lora_work_root()) as work:
            return _lora_round_run(name, preset, cfg, b, t, steps, work)
    finally:
        fam.PRESETS[preset] = cfg0


def _lora_round_run(name, preset, cfg, b, t, steps, work) -> dict:
    import math
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.engine.train import _wire_template
    from distributedtraining_tpu_torch.models import lora
    from distributedtraining_tpu_torch.neurons import averager as avg_cli
    from distributedtraining_tpu_torch.neurons import miner as miner_cli
    from distributedtraining_tpu_torch.neurons import validator as val_cli
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    lcfg = lora.LoRAConfig(rank=LORA_RANK)
    template = _wire_template(models.make_model(cfg)[0])
    L = cfg.n_layer
    fwd = (2 if cfg.remat else 1) * L        # remat recomputes the forward
    res: dict = {"model": preset, "n_layer": L, "batch": [b, t],
                 "steps": steps, "rank": LORA_RANK}
    t_ = LocalFSTransport(os.path.join(work, "artifacts"))
    t0 = time.perf_counter()
    rev0 = t_.publish_base(_lora_base(cfg))
    res["genesis_s"] = time.perf_counter() - t0
    lora_flags = ["--lora-rank", str(LORA_RANK)]
    miners = (("lora_fused", "hotkey_1", [*lora_flags, "--fused-loss",
                                          "--learning-rate", str(LORA_LR)]),
              ("lora", "hotkey_2", [*lora_flags,
                                    "--learning-rate", str(LORA_LR)]),
              ("full", "hotkey_3", ["--fused-loss", "--learning-rate",
                                    str(LORA_FULL_LR)]))
    with _LoraTap() as tap:
        for role, hotkey, extra in miners:
            run = _lora_cli(miner_cli, _lora_argv(
                work, preset, hotkey, b, t, [
                    "--max-steps", str(steps), "--send-interval", "1e9",
                    "--checkpoint-interval", "0", "--no-anomaly-trace",
                    *extra]))
            losses = tap.take_losses()
            what = f"lora {name} {role} miner"
            check(run["rc"] == 0, f"{what} CLI exited {run['rc']}")
            check(len(losses) == steps
                  and all(math.isfinite(x) for x in losses)
                  and losses[-1] < losses[0], f"{what} losses {losses}")
            want = {"flash_attention_fwd": fwd * steps,
                    "flash_attention_bwd_dkv": L * steps,
                    "flash_attention_bwd_dq": L * steps}
            if "--fused-loss" in extra:
                # a LoRA miner's head is frozen: dh alone, no dW
                want.update(fused_ce_fwd=steps, fused_ce_bwd_dh=steps,
                            fused_ce_bwd_dw=0 if role != "full" else steps)
            _check_launches(what, run["launches"], want)
            data = t_.fetch_delta_bytes(hotkey)
            check(data is not None, f"{what} pushed nothing")
            res[role] = {**run, "losses": losses, "artifact_bytes": len(data)}
        # an adapter artifact holds the adapters' f32 values and the
        # msgpack framing, nothing of the base
        n_ad = sum(fi * LORA_RANK + LORA_RANK * fo
                   for fi, fo in lora.targets(template, lcfg).values())
        for role in ("lora_fused", "lora"):
            size = res[role]["artifact_bytes"]
            check(4 * n_ad < size < 4 * n_ad + (1 << 20),
                  f"lora {name} {role} artifact {size} bytes for "
                  f"{n_ad} adapter values")
        res["adapter_values"] = n_ad
        res["densify"] = _lora_densify(t_.fetch_delta_bytes("hotkey_1"),
                                       template, lcfg)
        val = _lora_cli(val_cli, _lora_argv(
            work, preset, "hotkey_91", b, t, [*lora_flags, "--rounds", "1"]))
        check(val["rc"] == 0, f"lora {name} validator exited {val['rc']}")
        # the base's eval, then the three candidates, no backward
        _check_launches(f"lora {name} validator", val["launches"],
                        {"flash_attention_fwd": L * 2 * 4})
        with open(os.path.join(work, "chain", "metagraph.json")) as f:
            weights = json.load(f)["weights"].get("hotkey_91", {})
        check(all(weights.get(h, 0) > 0 for h in ("hotkey_1", "hotkey_2")),
              f"lora {name} validator weights {weights}")
        avg = _lora_cli(avg_cli, _lora_argv(
            work, preset, "hotkey_99", b, t, [*lora_flags, "--rounds", "1"]))
        check(avg["rc"] == 0, f"lora {name} averager exited {avg['rc']}")
        gathered = tap.gathered[-1] if tap.gathered else []
        check({"hotkey_1", "hotkey_2", "hotkey_3"} <= set(gathered),
              f"lora {name} averager merged {gathered}")
        check(avg["launches"]["dequant_scatter"] == 0
              and avg["launches"]["flash_attention_fwd"] > 0,
              f"lora {name} averager launches {avg['launches']}")
    res.update(validator=val, averager=avg,
               weights={h: w for h, w in weights.items() if w},
               merged=gathered, published=t_.base_revision() != rev0)
    return res


def lora_roles() -> dict:
    """28a-b, each round's seconds in ``times_s``."""
    t0 = time.perf_counter()
    res: dict = {"times_s": {}}
    for name in LORA_ROUNDS:
        t1 = time.perf_counter()
        res[name] = _lora_round(name)
        res["times_s"][name] = time.perf_counter() - t1
        log(f"lora {name}: {res['times_s'][name]:.1f} s",
            json.dumps(res[name], default=str)[:20000])
    res["s"] = time.perf_counter() - t0
    return res


def lora_child(out: str) -> int:
    """``--lora-child OUT``: 28a-b in a child process (after 27b-e's and
    before 26f's in the whole script, beside phases 22-25); its result
    as JSON in OUT."""
    phase_env()
    sys.path.insert(0, ROOT)
    res = lora_roles()
    with open(out, "w") as f:
        json.dump(res, f, default=str)
    return 0


def _lora_step_hook(eng, rows: list):
    """``_lt_step_hook`` for a LoRA engine's ``train_step(state, base,
    batch)``."""
    import torch
    step = eng.train_step

    def wrapped(state, base, batch):
        _lora_sync()
        t0 = time.perf_counter()
        out = step(state, base, batch)
        _lora_sync()
        rows.append((float(out[1]["loss"]), (time.perf_counter() - t0) * 1e3,
                     torch.cuda.max_memory_allocated() if DEV == "cuda"
                     else 0))
        log(f"lora step {len(rows)}: loss {rows[-1][0]:.4f}, "
            f"{rows[-1][1]:.1f} ms")
        return out

    eng.train_step = wrapped


def _lora_batches(tok, split: str, n: int, vocab: int) -> list:
    import numpy as np
    out = _batches(tok, split=split, batch_size=LORA_B, seq_len=LORA_T, n=n)
    for b in out:
        b["input_ids"] = (b["input_ids"] % vocab).astype(np.int32)
    return out


def _ce_plain_f64(h, w, y, g, want_dw: bool = False) -> dict:
    """The plain forward and backward in f64: ``loss``, ``m``, ``s``,
    ``dh`` and, with ``want_dw``, ``dw``. The f32 kernels' reference at
    E 4096, where cuBLAS's f32 logits stand as far from the exact ones
    as the f32 limit (s 1.3e-5 from the kernels' at both Llama heads)."""
    import torch
    h, w = h.double(), w.double()
    z = h @ w.T
    m = z.amax(dim=-1)
    p = torch.exp(z - m[:, None])
    s = p.sum(dim=-1)
    loss = m + torch.log(s) - torch.gather(z, 1, y.long()[:, None])[:, 0]
    dz = p / s[:, None]
    dz[torch.arange(len(y), device=z.device), y.long()] -= 1.0
    dz *= g.double()[:, None]
    out = {"loss": loss, "m": m, "s": s, "dh": dz @ w}
    if want_dw:
        out["dw"] = dz.T @ h
    return out


def _lora_ce(batch: dict) -> dict:
    """28c, CE: the forward and the frozen head's dh-only backward at
    ``llama2-7b``'s head (E 4096, V 32000) on the main path's rows of
    ``batch`` (its targets and mask, bf16) against the plain forward and
    ``fused_ce_bwd_reference(want_dw=False)`` in f32, and on 256 rows in
    f32 against the same in f64 (the f32 plain's own error reported),
    with ``_ce_check``'s limits (a planted wrong dh must fail them); then
    timed in bf16 beside the bound, the plain versions
    and the library's path (its autograd to h alone: the head is
    frozen)."""
    import torch
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch import models
    cfg = models.llama.PRESETS[LORA_PRESET]
    V, E = cfg.padded_vocab, cfg.n_embd
    ids, msk = batch["input_ids"][:, 1:], batch["loss_mask"][:, 1:]
    n = ids.size
    bf = torch.bfloat16
    checks = []
    for i, (name, rows, dtype, kw) in enumerate((
            (f"llama2_7b_n{n}_bf16", n, bf, dict(labels=ids, mask=msk)),
            ("llama2_7b_n256_f32", 256, torch.float32, {}))):
        h, w, y, g = _lt_ce_inputs(rows, V, E, dtype, SEED + 50 + i, **kw)
        loss, m, s = fused_ce.fused_ce_fwd(h, w, y)
        dh = fused_ce.fused_ce_bwd_dh(h, w, y, m, s, g)
        hf, wf = h.float(), w.float()
        r_loss, r_m, r_s = fused_ce.fused_ce_fwd_reference(hf, wf, y)
        r_dh, r_dw = fused_ce.fused_ce_bwd_reference(hf, wf, y, r_m, r_s, g,
                                                     want_dw=False)
        check(r_dw is None, "the frozen head's plain backward gave a dW")
        plain = {"loss": r_loss, "m": r_m, "s": r_s, "dh": r_dh}
        dt = str(dtype).split(".")[1]
        case = {"case": name, "dtype": dt, "N": rows, "V": V, "E": E,
                "tol": CE_TOL[dt]}
        if dtype == torch.float32:
            exact = _ce_plain_f64(h, w, y, g)
            case["plain_f32_vs_f64"] = {
                k: x for k, (_, x) in _ce_limit_errors(
                    {k: (plain[k], exact[k]) for k in plain}, dt).items()}
            plain = exact
        outs = {"loss": (loss, plain["loss"]), "m": (m, plain["m"]),
                "s": (s, plain["s"]), "dh": (dh, plain["dh"])}
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(a.float()).all())
                  for a, _ in outs.values()),
              f"fused CE kernels: non-finite output at {name}")
        errs = _ce_check(name, outs, dt)
        checks.append({**case,
                       "max_abs": {k: d for k, (d, _) in errs.items()},
                       "err": {k: x for k, (_, x) in errs.items()}})
        del outs, plain, h, w, y, g, hf, wf, dh, r_dh, m, s, r_m, r_s
        torch.cuda.empty_cache()
    h, w, y, g = _lt_ce_inputs(n, V, E, bf, SEED + 50, labels=ids, mask=msk)
    loss, m, s = fused_ce.fused_ce_fwd(h, w, y)
    hh = h.detach().requires_grad_()
    ce = torch.nn.functional.cross_entropy

    def lib_fwd():
        return ce((hh @ w.T).float(), y.long(), reduction="none")

    out = lib_fwd()
    bounds = _ce_bounds(n, V, E)
    runs = {
        "fused_ce_fwd": (lambda: fused_ce.fused_ce_fwd(h, w, y),
                         lambda: fused_ce.fused_ce_fwd_reference(h, w, y),
                         lib_fwd),
        "fused_ce_bwd_dh": (
            lambda: fused_ce.fused_ce_bwd_dh(h, w, y, m, s, g),
            lambda: fused_ce.fused_ce_bwd_reference(h, w, y, m, s, g,
                                                    want_dw=False),
            lambda: torch.autograd.grad(out, (hh,), g, retain_graph=True))}
    timed = {}
    for name, (fn, plain, lib) in runs.items():
        timed[name] = {"ms": _time_ms(fn),
                       "plain_ms": _time_ms(plain, reps=5, warm=1),
                       "library_ms": _time_ms(lib),
                       "bound_ms": bounds[name][0],
                       "bound_by": bounds[name][1]}
    del h, w, hh, out, m, s
    torch.cuda.empty_cache()
    return {"checks": checks, "timed": timed,
            "timed_shape": f"N {n}, V {V}, E {E}, bf16 h and head",
            "library": "cuBLAS bf16 GEMM to the logits (cast to f32) + "
                       "F.cross_entropy; backward: its autograd to h alone",
            "plain": "fused_ce_fwd_reference; fused_ce_bwd_reference("
                     "want_dw=False) on the bf16 inputs"}


def lora_big(tok) -> dict:
    """28c (``--lora``): ``llama2-7b`` at full width and depth on one
    card (see the module docstring)."""
    import math
    import torch
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.engine.lora_train import (
        LoRAEngine, LoRAMinerLoop)
    from distributedtraining_tpu_torch.engine.scheduler import FakeClock
    from distributedtraining_tpu_torch.engine.train import (
        _wire_template, default_optimizer)
    from distributedtraining_tpu_torch.models import lora
    from distributedtraining_tpu_torch.transport import InMemoryTransport
    cfg = models.llama.PRESETS[LORA_PRESET]
    model = models.make_model(cfg)[0]
    lcfg = lora.LoRAConfig(rank=LORA_RANK)
    n_params = sum(v.numel() for v in model.state_dict().values())
    train = _lora_batches(tok, "train", LORA_STEPS, cfg.vocab_size)
    held = _lora_batches(tok, "test", LORA_HELD, cfg.vocab_size)
    ce = _lora_ce(train[0])
    eng = LoRAEngine(model, lcfg, optimizer=default_optimizer(LORA_BIG_LR),
                     fused_loss=True, device=DEV)
    rows: list = []
    _lora_step_hook(eng, rows)
    t = InMemoryTransport()
    miner = LoRAMinerLoop(eng, t, "hotkey_1", clock=FakeClock(),
                          send_interval=1e9, check_update_interval=1e9)
    _lt_free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = _drawn_state(cfg, SEED)      # the genesis base, on the card
    _lora_sync()
    draw_s = time.perf_counter() - t0
    base_bytes = sum(v.numel() * v.element_size() for v in state.values())
    # main path: counts to 0 just before, read just after
    _lt_zero()
    t0 = time.perf_counter()
    miner.bootstrap(params=lambda: state, seed=SEED)
    del state
    report = miner.run(iter(train))
    miner.flush()
    _lora_sync()
    loop_s = time.perf_counter() - t0
    launches = _lt_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [r[0] for r in rows]
    step_ms = [r[1] for r in rows]
    L, steps = cfg.n_layer, len(rows)
    check(steps == LORA_STEPS and report.pushes == 1
          and report.pushes_failed == 0,
          f"lora 7b miner: {steps} steps, pushes {report.pushes}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"lora 7b miner losses {losses}")
    _check_launches("lora 7b miner", launches, {
        "flash_attention_fwd": 2 * L * steps,
        "flash_attention_bwd_dkv": L * steps,
        "flash_attention_bwd_dq": L * steps,
        "fused_ce_fwd": steps, "fused_ce_bwd_dh": steps})
    # one more step under the profiler (after the counts were read)
    prof, _ = _device_profile(lambda: eng.train_step(
        miner.state, miner.base_params, eng.place_batch(train[0])), top=8)
    # held-out: base + trained adapters against the base (b = 0)
    zero = eng.init_state(SEED).params
    base_loss = eng.evaluate_adapters(zero, miner.base_params, held)[0]
    held_loss = eng.evaluate_adapters(miner.state.params, miner.base_params,
                                      held)[0]
    check(held_loss < base_loss, f"lora 7b held-out {held_loss} >= the "
                                 f"base's {base_loss}")
    data = t.fetch_delta_bytes("hotkey_1")
    n_ad = sum(x.numel() for x in miner.state.params.values())
    check(data is not None and 4 * n_ad < len(data) < 4 * n_ad + (1 << 20),
          f"lora 7b artifact {None if data is None else len(data)} bytes "
          f"for {n_ad} adapter values")
    dens = _lora_densify(data, _wire_template(model), lcfg)
    miner.close()
    p50 = statistics.median(step_ms[1:] or step_ms)
    return {"model": LORA_PRESET, "n_layer": L, "n_params": n_params,
            "base_bytes": base_bytes, "rank": LORA_RANK,
            "adapter_values": n_ad, "artifact_bytes": len(data),
            "batch": [LORA_B, LORA_T], "steps": steps, "lr": LORA_BIG_LR,
            "losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
            "tokens_per_s": LORA_B * LORA_T / p50 * 1e3,
            "held_out_base": base_loss, "held_out_trained": held_loss,
            "steps_peak_cuda_mem_bytes": max(r[2] for r in rows),
            "peak_cuda_mem_bytes": peak, "draw_s": draw_s, "loop_s": loop_s,
            "launches": launches, "densify": dens, "step_profile": prof,
            "remat": cfg.remat, "ce": ce}


def _lora_mesh_run(name: str, axes: dict, batches: dict, mesh) -> dict:
    """One LoRA miner of 28d: ``LT_MESH_STEPS`` steps of a
    ``LoRAMinerLoop`` (fused loss, f32) over an in-memory transport from
    the seeded genesis base, on this rank's rows (world 1: ``mesh``
    None), then its push; the losses, launches, block routes, and the
    sum of the pushed adapters' magnitudes."""
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.delta import flatten_tree
    from distributedtraining_tpu_torch.engine.lora_train import (
        LoRAEngine, LoRAMinerLoop)
    from distributedtraining_tpu_torch.engine.scheduler import FakeClock
    from distributedtraining_tpu_torch.engine.train import default_optimizer
    from distributedtraining_tpu_torch.models import lora
    from distributedtraining_tpu_torch.parallel import batch_rows, sharding
    from distributedtraining_tpu_torch.transport import InMemoryTransport
    cfg = _lt_mesh_cfg(None)
    eng = LoRAEngine(models.make_model(cfg)[0],
                     lora.LoRAConfig(rank=LORA_RANK),
                     optimizer=default_optimizer(LORA_LR), fused_loss=True,
                     mesh=mesh, device=DEV)
    rows: list = []
    _lora_step_hook(eng, rows)
    miner = LoRAMinerLoop(eng, InMemoryTransport(), "hotkey_1",
                          clock=FakeClock(), send_interval=1e9,
                          check_update_interval=1e9)
    miner.bootstrap(params=lambda: flatten_tree(
        models.init_params_numpy(cfg, SEED)), seed=SEED)
    data = batches["packed"]
    if mesh is not None:
        data = [batch_rows(b, mesh) for b in data]
    sharding.reset_counts()
    _lt_zero()
    report = miner.run(iter(data))
    miner.flush()
    _lora_sync()
    launches = _lt_launches()
    miner.close()
    return {"losses": [r[0] for r in rows], "launches": launches,
            "routes": {k: v for k, v in sharding.counts.items()
                       if k.startswith("tp_")},
            "tp_route": eng.tp_route, "pushes": report.pushes,
            "adapter_abs_sum": float(sum(v.detach().abs().sum()
                                         for v in miner.state.params.values()))}


def lora_worker(rank: int, port: int, tmp: str) -> int:
    """One rank of 28d's world of two over gloo on this card
    (``--lora-worker``): every mesh of ``LORA_MESHES``; its results in
    ``tmp/out_<rank>.json``."""
    import torch
    from distributedtraining_tpu_torch.parallel import (Mesh, MeshConfig,
                                                        multihost)
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"127.0.0.1:{port}", 2, rank, device=DEV,
                         backend="gloo", timeout_s=PAR_TIMEOUT_S)
    out = {"rank": rank}
    try:
        batches = _sp_arrays_from(os.path.join(tmp, "lt_batches.npz"))
        for name, axes in LORA_MESHES.items():
            mesh = Mesh(MeshConfig(**axes))
            out[name] = _lora_mesh_run(name, axes, batches, mesh)
    finally:
        multihost.shutdown()
    return _par_worker_done(tmp, rank, out)


def _lora_mesh(tok) -> dict:
    """28d: phase 27's tiny-llama widened to E 256 (f32) on a world of
    two over gloo, both ranks on this card (``--lora-worker``): LoRA
    miners at fsdp 2 and tp 2 (heads split), each rank's losses within
    ``LT_F32_TOL`` of world 1's, the adapters the same on both ranks,
    launches (CE dW none) and block routes exact, one push."""
    import tempfile
    cfg = _lt_mesh_cfg(None)
    L, steps = cfg.n_layer, LT_MESH_STEPS
    res: dict = {"model": "tiny-llama", **LT_MESH_CFG,
                 "batch": [LT_MESH_B, LT_MESH_T], "steps": steps}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _lt_mesh_batches(tok, tmp)
        batches = _sp_arrays_from(os.path.join(tmp, "lt_batches.npz"))
        w1 = _lora_mesh_run("world1", {}, batches, None)
        outs = _par_spawn(2, "gloo", {}, tmp, "lora world 2",
                          mode="--lora-worker")
    want = {"flash_attention_fwd": L * steps,
            "flash_attention_bwd_dkv": L * steps,
            "flash_attention_bwd_dq": L * steps,
            "fused_ce_fwd": steps, "fused_ce_bwd_dh": steps}
    _check_launches("lora world 1", w1["launches"], want)
    for name, axes in LORA_MESHES.items():
        tp = axes.get("tp", 1)
        route = (None if tp == 1 else "head_split"
                 if cfg.n_kv_head % tp == 0 else "gathered_attn")
        for r, o in enumerate(outs):
            run = o[name]
            what = f"lora world 2 {name} rank {r}"
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(run["losses"], w1["losses"]))
            check(len(run["losses"]) == steps and rel <= LT_F32_TOL,
                  f"{what}: losses {run['losses']} vs world 1 "
                  f"{w1['losses']} ({rel})")
            _check_launches(what, run["launches"], want)
            check(run["tp_route"] == route,
                  f"{what}: route {run['tp_route']} != {route}")
            want_r = {f"tp_{x}_blocks": L * steps if x == route else 0
                      for x in ("head_split", "gathered_attn")}
            check(run["routes"] == want_r,
                  f"{what}: routes {run['routes']} != {want_r}")
        sums = [o[name]["adapter_abs_sum"] for o in outs]
        check(sums[0] == sums[1], f"lora world 2 {name}: the ranks' "
                                  f"adapters differ ({sums})")
        check(outs[0][name]["pushes"] == 1,
              f"lora world 2 {name}: the coordinator pushed "
              f"{outs[0][name]['pushes']}")
        res[name] = {"mesh": axes, "world1": w1["losses"],
                     "losses": [o[name]["losses"] for o in outs],
                     "launches": outs[0][name]["launches"], "route": route,
                     "adapter_abs_sum": sums[0],
                     "world1_adapter_abs_sum": w1["adapter_abs_sum"]}
    res["s"] = time.perf_counter() - t0
    return res


def _lora_entries(entries: list, roles: dict) -> list:
    """The kernels line's flash and CE entries, each with phase 28's
    launches by round and miner (a LoRA miner's CE dW is 0)."""
    for e in entries:
        if not (e["name"].startswith("flash_attention")
                or e["name"].startswith("fused_ce")):
            continue
        counter = ("fused_ce_bwd_dh" if e["name"] == "fused_ce_bwd"
                   else e["name"])
        e["lora"] = {
            f"launches_{rnd}_{role}": roles[rnd][role]["launches"].get(
                counter, 0)
            for rnd in LORA_ROUNDS
            for role in ("lora_fused", "lora", "full", "validator")}
        if e["name"] == "fused_ce_bwd":
            e["lora"].update({
                f"launches_dw_{rnd}_{role}": roles[rnd][role][
                    "launches"]["fused_ce_bwd_dw"]
                for rnd in LORA_ROUNDS for role in ("lora_fused", "full")})
    return entries


def lora_only() -> int:
    """Phase 28's heavy part alone after the build (``--lora``): 28c,
    28d, then 28a-b; the kernels line of the five kernels they run
    (their LoRA readings), the ``lora`` line, the card's line and the
    result line."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    build = phase_build()
    tok = _tokenizer()
    res: dict = {"times_s": {}}
    for name, fn in (("big", lora_big), ("mesh", _lora_mesh),
                     ("roles", lambda tok: lora_roles())):
        t0 = time.perf_counter()
        res[name] = fn(tok)
        res["times_s"][name] = time.perf_counter() - t0
        log(f"lora {name}: {res['times_s'][name]:.1f} s",
            json.dumps(res[name], default=str)[:20000])
        _lt_free()
    big = res["big"]["launches"]
    entries = [{"name": name, "route": "cuda", "source": source,
                "build_s": build["build_s"],
                "launches_lora_7b": big.get(name, 0)}
               for name, source in (
                   ("flash_attention_fwd", FLASH_SOURCE),
                   ("flash_attention_bwd_dkv", FLASH_SOURCE),
                   ("flash_attention_bwd_dq", FLASH_SOURCE),
                   ("fused_ce_fwd", CE_SOURCE),
                   ("fused_ce_bwd_dh", CE_SOURCE),
                   ("fused_ce_bwd_dw", CE_SOURCE))]
    ce = res["big"]["ce"]
    for e in entries:
        if e["name"] in ce["timed"]:
            out = "loss" if e["name"] == "fused_ce_fwd" else "dh"
            e["llama2_7b_head"] = {
                **ce["timed"][e["name"]], "shape": ce["timed_shape"],
                "max_abs_err": max(c["max_abs"][out] for c in ce["checks"])}
    print(json.dumps({"kernels": _lora_entries(entries, res["roles"])}),
          flush=True)
    print(json.dumps({"lora": {**res, "card": card}}, default=str),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _soak_checked(mod, name: str, last: list, bounds: dict) -> None:
    """Wrap ``mod.name`` (a kernel's wrapper): the card synchronised
    before the launch (a fault there lies in what ran since ``last[0]``)
    and after it (a fault there is this kernel's), its tensor inputs and
    outputs finite (but the flash kernels' ``[B, H, T]`` row statistics,
    where a row with no visible key may hold -inf) and its int32 inputs
    within ``bounds[name]``."""
    import torch
    fn = getattr(mod, name)

    def sync(where: str) -> None:
        try:
            torch.cuda.synchronize()
        except Exception as e:          # a sticky CUDA error
            raise SmokeFailure(f"lora soak: CUDA error {where}: {e}")

    def scan(tensors, what: str) -> None:
        for i, t in enumerate(tensors):
            if not isinstance(t, torch.Tensor):
                continue
            if t.is_floating_point() and t.dim() != 3:
                check(bool(torch.isfinite(t).all()),
                      f"lora soak: {name} {what} {i} not finite")
            elif t.dtype == torch.int32 and t.numel():
                lo, hi = int(t.min()), int(t.max())
                check(bounds[name][0] <= lo and hi < bounds[name][1],
                      f"lora soak: {name} {what} {i} in [{lo}, {hi}]")

    def run(*args, **kw):
        sync(f"before {name} (after {last[0]})")
        scan(args, "input")
        out = fn(*args, **kw)
        sync(f"in {name}")
        scan(out if isinstance(out, tuple) else (out,), "output")
        last[0] = name
        return out

    setattr(mod, name, run)


def lora_soak(argv: list) -> int:
    """``--lora-soak STEPS [--checked]``: 28c's ``llama2-7b`` LoRA step
    (full depth, B 4 x T 1024, fused loss, the seeded genesis base drawn
    on the card) STEPS times over a cycle of 8 batches, the card
    synchronised after each step; with ``--checked`` every flash and CE
    launch is checked as ``_soak_checked`` says. Prints a ``lora_soak``
    line (steps run, losses' range, step ms), the card's line and the
    result line."""
    import math
    import torch
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.engine.lora_train import LoRAEngine
    from distributedtraining_tpu_torch.engine.train import default_optimizer
    from distributedtraining_tpu_torch.models import lora
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    steps, checked = int(argv[0]), "--checked" in argv[1:]
    card = phase_env()
    sys.path.insert(0, ROOT)
    phase_build()
    cfg = models.llama.PRESETS[LORA_PRESET]
    train = _lora_batches(_tokenizer(), "train", 8, cfg.vocab_size)
    if checked:
        last = ["the step's start"]
        seg = (0, 1 << 30)
        for mod, name, bound in (
                (fa, "flash_attention_fwd", seg),
                (fa, "flash_attention_bwd_dkv", seg),
                (fa, "flash_attention_bwd_dq", seg),
                (fused_ce, "fused_ce_fwd", (0, cfg.padded_vocab)),
                (fused_ce, "fused_ce_bwd_dh", (0, cfg.padded_vocab))):
            _soak_checked(mod, name, last, {name: bound})
    eng = LoRAEngine(models.make_model(cfg)[0],
                     lora.LoRAConfig(rank=LORA_RANK),
                     optimizer=default_optimizer(LORA_BIG_LR),
                     fused_loss=True, device=DEV)
    base = eng.place_base(_drawn_state(cfg, SEED))
    state = eng.init_state(SEED)
    batches = [eng.place_batch(b) for b in train]
    losses, ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = eng.train_step(state, base, batches[i % len(batches)])
        _lora_sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if i % 25 == 0 or i == steps - 1:
            log(f"lora soak step {i + 1}: loss {losses[-1]:.4f}, "
                f"{ms[-1]:.1f} ms")
        check(math.isfinite(losses[-1]),
              f"lora soak: step {i + 1} loss {losses[-1]}")
    res = {"steps": steps, "checked": checked, "model": LORA_PRESET,
           "batch": [LORA_B, LORA_T], "loss_first": losses[0],
           "loss_last": losses[-1], "loss_min": min(losses),
           "loss_max": max(losses),
           "step_ms_p50": statistics.median(ms[1:] or ms),
           "step_ms_max": max(ms[1:] or ms), "first_step_ms": ms[0],
           "peak_cuda_mem_bytes": torch.cuda.max_memory_allocated()}
    print(json.dumps({"lora_soak": {**res, "card": card}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# 29. convert: --init-from (the HF converters, safetensors), --scan-blocks
# ---------------------------------------------------------------------------

CONVERT_REPO = "openai-community/gpt2"
CONVERT_COMMIT = "0123456789abcdef0123456789abcdef01234567"
CONVERT_STEPS = 8
CONVERT_B, CONVERT_T = 4, 512
CONVERT_EVAL = ["--eval-batches", "2", "--eval-seq-len", "256"]
CONVERT_TIMEOUT_S = 900.0
# --convert: the Llama-2-7B checkpoint (bf16, two shards, ~13.5 GB)
CONVERT_BIG = "llama2-7b"
CONVERT_BIG_STEPS = 6
CONVERT_BIG_DISK_BYTES = 20 * 10**9
CONVERT_BIG_TIMEOUT_S = 900.0


def _hf_cache_gpt2(root: str, cfg) -> dict:
    """An HF-layout GPT-2 checkpoint of seeded random weights in a local
    HF cache under ``root``: one f32 ``model.safetensors`` named as HF's
    GPT-2 file names its tensors (``h.0.attn.c_attn.weight``, ...; no
    ``lm_head.weight``: the head is tied) in
    ``models--openai-community--gpt2/snapshots/<commit>/``, with
    ``refs/main`` naming the commit. Returns the tree the checkpoint
    holds in the port's layout (the seeded init, its padded vocabulary
    rows zero: HF stores the real vocabulary)."""
    from distributedtraining_tpu_torch import serialization as ser
    from distributedtraining_tpu_torch.models import convert, gpt2
    tree = gpt2.init_params_numpy(cfg, SEED + 29)
    hf = {k.removeprefix("transformer."): v
          for k, v in convert.gpt2_to_hf(tree, cfg).items()
          if k != "lm_head.weight"}
    folder = os.path.join(root, "models--" + CONVERT_REPO.replace("/", "--"))
    snap = os.path.join(folder, "snapshots", CONVERT_COMMIT)
    os.makedirs(snap)
    os.makedirs(os.path.join(folder, "refs"))
    with open(os.path.join(folder, "refs", "main"), "w") as f:
        f.write(CONVERT_COMMIT)
    ser.save_file(hf, os.path.join(snap, "model.safetensors"))
    tree["wte"][cfg.vocab_size:] = 0
    return tree


class _ConvertTap:
    """Class-level hooks on what the role CLIs build: each role's base
    right after its bootstrap held against ``want`` (a state dict on the
    card, unrolled) in the engine's layout, each train step's loss and
    synchronised ms, and each ``--init-from`` conversion's seconds."""

    def __init__(self, want: dict):
        self.want = want
        self.seen: dict = {}
        self.losses: list = []
        self.step_ms: list = []
        self.convert_s: list = []

    def _base(self, role: str, loop) -> None:
        import torch
        from distributedtraining_tpu_torch import models
        base = {k: v.detach() for k, v in loop.base_params.items()}
        cfg = loop.engine.model.cfg
        stacked = sorted({tuple(v.shape)[:1] for k, v in base.items()
                          if ".block." in k})
        if cfg.scan_blocks:
            base = models.unstack_blocks(cfg, base)
        same = base.keys() == self.want.keys() and all(
            torch.equal(base[k], self.want[k]) for k in base)
        state = getattr(loop, "state", None)
        self.seen.setdefault(role, []).append({
            "equal": same, "scan": cfg.scan_blocks,
            "stacked_leading": [s[0] for s in stacked],
            "state_block_leaves": None if state is None else sorted(
                k for k in state.params if ".block." in k)[:3]})

    def __enter__(self):
        from distributedtraining_tpu_torch.engine.average import \
            AveragerLoop
        from distributedtraining_tpu_torch.engine.train import (MinerLoop,
                                                                TrainEngine)
        from distributedtraining_tpu_torch.engine.validate import Validator
        from distributedtraining_tpu_torch.models import convert
        tap, self._undo = self, []

        def hook(owner, name, wrap):
            real = getattr(owner, name)
            setattr(owner, name, wrap(real))
            self._undo.append((owner, name, real))

        def boot(role):
            def wrap(real):
                def run(loop, *a, **kw):
                    out = real(loop, *a, **kw)
                    tap._base(role, loop)
                    return out
                return run
            return wrap

        def step(real):
            def run(eng, state, batch):
                _lora_sync()
                t0 = time.perf_counter()
                out = real(eng, state, batch)
                tap.losses.append(float(out[1]["loss"]))
                tap.step_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return run

        def timed(real):
            def run(*a, **kw):
                t0 = time.perf_counter()
                out = real(*a, **kw)
                tap.convert_s.append(time.perf_counter() - t0)
                return out
            return run

        hook(MinerLoop, "bootstrap", boot("miner"))
        hook(Validator, "bootstrap", boot("validator"))
        hook(AveragerLoop, "bootstrap", boot("averager"))
        hook(TrainEngine, "train_step", step)
        hook(convert, "load_params", timed)
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)

    def take(self) -> tuple:
        out = (self.losses, self.step_ms, self.convert_s)
        self.losses, self.step_ms, self.convert_s = [], [], []
        return out


# 29's text runs: the repository's own markdown as the files corpus
TEXT_DOCS = os.path.join("docs", "**", "*.md")
TEXT_BPE_VOCAB = 32000
TEXT_PACK_REPEAT = 40          # the packers' timing: the corpus 40 times


class _TextRuns:
    """Phase 29's two miner CLI runs on local text at GPT-2-124M
    (``--fused-loss``, B ``CONVERT_B`` x T ``CONVERT_T``,
    ``CONVERT_STEPS`` steps). Run A (:meth:`run_a`), first in the phase's
    process, before it has loaded any kernel or the packer:
    ``--tokenizer bpe --dataset files:<repo>/docs/**/*.md
    --compile-cache-dir <fresh dir>``, the BPE trained here first on the
    same files and saved where the miner looks for it (or ``--tokenizer
    word`` where ``tokenizers`` cannot be imported). Run B
    (:meth:`finish`), at the phase's end once its runs have freed the
    card's memory, as a restart: the same ``--compile-cache-dir`` and
    neither ``--tokenizer`` nor ``--dataset`` (JAX's defaults, ``auto``
    and ``auto``). Both run in the phase's process: a process of their
    own beside the phase's would take card memory that the llama-train
    child's peak needs."""

    def __init__(self, tmp: str, cfg):
        self.tmp = os.path.join(tmp, "text")
        self.cache = os.path.join(self.tmp, "compile_cache")
        os.makedirs(self.tmp)
        self.pattern = os.path.join(ROOT, TEXT_DOCS)
        self.libs = _text_libs()
        self.res: dict = {"libs": self.libs, "docs": TEXT_DOCS,
                          "times_s": {}}
        self.work_a = os.path.join(self.tmp, "a")
        self.vocab = None
        self.tok = ["--tokenizer", "word"]
        if self.libs["tokenizers"]:
            from distributedtraining_tpu_torch.data.bpe import (
                BPETokenizer, corpus_files)
            t0 = time.perf_counter()
            # the vocabulary and the file the miner's build asks for
            vocab = min(cfg.vocab_size, TEXT_BPE_VOCAB)
            self.bpe_path = os.path.join(self.work_a, "tokenizer",
                                         f"bpe-{vocab}.json")
            files = corpus_files((self.pattern,))
            bpe = BPETokenizer.train(vocab_size=vocab, files=files,
                                     save_path=self.bpe_path)
            self.vocab = bpe.vocab_size
            self.res["bpe"] = {"files": len(files),
                               "bytes": sum(map(os.path.getsize, files)),
                               "vocab_size": bpe.vocab_size,
                               "train_s": time.perf_counter() - t0}
            self.tok = ["--tokenizer", "bpe"]
        self.res["tokenizer_a"] = self.tok[1]

    def _argv(self, work: str, hotkey: str, extra: list) -> list:
        return ["--backend", "local", "--work-dir", work, "--model",
                "gpt2-124m", "--hotkey", hotkey, "--no-base-wire-v2",
                "--flight-events", "0", "--batch-size", str(CONVERT_B),
                "--seq-len", str(CONVERT_T), *CONVERT_EVAL,
                "--max-steps", str(CONVERT_STEPS), "--send-interval", "1e9",
                "--checkpoint-interval", "0", "--no-anomaly-trace",
                "--fused-loss", "--compile-cache-dir", self.cache, *extra]

    def _check(self, what: str, run: dict, cfg) -> None:
        import math
        losses = run["losses"]
        check(run["rc"] == 0, f"{what} CLI exited {run['rc']}")
        check(len(losses) == CONVERT_STEPS
              and all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0], f"{what} losses {losses}")
        _check_launches(what, run["launches"],
                        _train_want(cfg, CONVERT_STEPS, True))
        check(run["build_dir"] == self.cache,
              f"{what}: built into {run['build_dir']}, not {self.cache}")

    def _run(self, what: str, argv: list) -> dict:
        """One text run's miner CLI in this process under the taps, the
        launch counts at 0 just before; the build directory back to the
        whole script's after (the phase's other CLIs load from it)."""
        from distributedtraining_tpu_torch import native
        from distributedtraining_tpu_torch.neurons import miner as miner_cli
        from distributedtraining_tpu_torch.ops import _cuda
        run: dict = {}
        off = _text_taps(run)
        prev, before = _cuda.BUILD_DIR, _cuda.compiles
        t0 = time.perf_counter()
        try:
            run.update(_lora_cli(miner_cli, argv))
            run.update(compiles=_cuda.compiles - before,
                       build_dir=str(_cuda.BUILD_DIR),
                       host_compiler=native.compiler()[0])
        finally:
            off()
            _cuda.BUILD_DIR = prev
        self.res["times_s"][what] = time.perf_counter() - t0
        return run

    def run_a(self, cfg) -> None:
        """Run A and its checks: the kernels and the packer it loads are
        built into the fresh directory."""
        a = self._run("a", self._argv(
            self.work_a, "hotkey_1",
            self.tok + ["--dataset", f"files:{self.pattern}"]))
        self._check("text run A", a, cfg)
        vocab = self.vocab or cfg.vocab_size
        check(a["ids_max"] < vocab,
              f"text run A: input id {a['ids_max']} >= vocab {vocab}")
        check(a["tokenizer"] == ({"class": "BPETokenizer",
                                  "vocab_size": self.vocab} if self.vocab
                                 else {"class": "WordTokenizer",
                                       "vocab_size": cfg.vocab_size}),
              f"text run A's tokenizer {a['tokenizer']}")
        check(all(c["resolved"] == "files" for c in a["corpora"]),
              f"text run A's corpora {a['corpora']}")
        built = {c["library"].split("-")[0] for c in a["compiled"]}
        check({"libflash_attention", "libfused_ce", "libpacking"} <= built
              and all(c["dir"] == self.cache for c in a["compiled"]),
              f"text run A built {a['compiled']}")
        self.res["a"] = a

    def finish(self, cfg) -> dict:
        """Run B and its checks, as a restart meets the directory: the
        libraries this process loaded are forgotten first, so that each
        kernel and the packer go through ``build`` again; then the
        packers on run A's corpus and ids."""
        from distributedtraining_tpu_torch import native
        from distributedtraining_tpu_torch.ops import (_cuda, dequant_scatter,
                                                       flash_attention,
                                                       fused_ce,
                                                       paged_attention)
        for cached in (flash_attention._kernels, fused_ce._kernels,
                       paged_attention._kernel, paged_attention._window_kernel,
                       paged_attention._window_split_kernel,
                       dequant_scatter._kernel):
            cached.cache_clear()
        _cuda._LIBS.clear()
        native._LIBS.clear()
        b = self._run("b", self._argv(os.path.join(self.tmp, "b"),
                                      "hotkey_2", []))
        self._check("text run B", b, cfg)
        check(b["compiles"] == 0 and not b["compiled"]
              and b["builds"] and all(x["s"] == 0.0 for x in b["builds"]),
              f"text run B built again: {b['compiled']} {b['builds']}")
        self.res["b"] = b
        self.res["b_resolved"] = {
            "tokenizer": b["tokenizer"],
            "corpus": sorted({c["resolved"] for c in b["corpora"]})}
        self.res["packers"] = self._packers(cfg)
        return self.res

    def _packers(self, cfg) -> dict:
        """The C++ packer's rows against the Python loop's on run A's
        corpus and tokenizer (T ``CONVERT_T``, the corpus
        ``TEXT_PACK_REPEAT`` times), every field; each one's rows/s on
        this machine's host."""
        import numpy as np
        from distributedtraining_tpu_torch import native
        from distributedtraining_tpu_torch.data import datasets, packing
        docs = datasets.text_corpus(split="train",
                                    source=f"files:{self.pattern}")
        if self.vocab:
            from distributedtraining_tpu_torch.data.bpe import BPETokenizer
            tok = BPETokenizer.load(self.bpe_path)
        else:
            tok = datasets.WordTokenizer(docs, vocab_size=cfg.vocab_size)
        ids = [np.asarray(tok.encode(d), np.int32) for d in docs]
        ids = ids * TEXT_PACK_REPEAT
        out = {"docs": len(docs), "tokens": int(sum(map(len, ids))),
               "seq_len": CONVERT_T, "compiler": native.compiler()[0]}
        rows = {}
        for name, flag in (("native", True), ("python", False)):
            t0 = time.perf_counter()
            rows[name] = list(packing.pack_documents(ids, CONVERT_T,
                                                     native=flag))
            secs = time.perf_counter() - t0
            out[name] = {"rows": len(rows[name]), "s": secs,
                         "rows_per_s": len(rows[name]) / secs}
        check(len(rows["native"]) == len(rows["python"]) > 0 and all(
            np.array_equal(x[k], y[k]) and x[k].dtype == y[k].dtype
            for x, y in zip(rows["native"], rows["python"]) for k in y),
            "text packers: the C++ packer's rows differ from the Python "
            "loop's")
        out["equal"] = True
        return out


def _convert_argv(work: str, hotkey: str, extra: list) -> list:
    return [*DEFAULT_FLAGS, "--backend", "local", "--work-dir", work,
            "--model", "gpt2-124m", "--hotkey", hotkey, "--init-from",
            f"hf:{CONVERT_REPO}", "--no-base-wire-v2", "--flight-events",
            "0", "--batch-size", str(CONVERT_B), "--seq-len",
            str(CONVERT_T), *CONVERT_EVAL, *extra]


def _convert_seen(tap: _ConvertTap, role: str, what: str) -> dict:
    seen = tap.seen.get(role) or [None]
    check(len(seen) == 1 and seen[0]["equal"],
          f"convert {what}: its first params are not the checkpoint's "
          f"({seen})")
    return seen[0]


def phase_convert_roles() -> dict:
    """29 (see the module docstring): the four role CLIs with
    ``--init-from hf:openai-community/gpt2`` at GPT-2-124M, and a
    ``--scan-blocks`` miner against the unrolled one."""
    import math
    import tempfile
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch import serialization as ser
    from distributedtraining_tpu_torch.delta import flatten_tree
    from distributedtraining_tpu_torch.engine.train import _wire_template
    from distributedtraining_tpu_torch.neurons import averager as avg_cli
    from distributedtraining_tpu_torch.neurons import miner as miner_cli
    from distributedtraining_tpu_torch.neurons import validator as val_cli
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    cfg = models.gpt2.PRESETS["gpt2-124m"]
    L = cfg.n_layer
    res: dict = {"model": "gpt2-124m", "repo": CONVERT_REPO,
                 "batch": [CONVERT_B, CONVERT_T], "steps": CONVERT_STEPS,
                 "times_s": {}}
    prev = os.environ.get("HF_HUB_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        # run A first: this process has loaded no kernel and no packer
        text = _TextRuns(tmp, cfg)
        text.run_a(cfg)
        t0 = time.perf_counter()
        cache = os.path.join(tmp, "hub")
        tree = _hf_cache_gpt2(cache, cfg)
        res["times_s"]["write"] = time.perf_counter() - t0
        res["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, fs in os.walk(cache) for f in fs)
        want = models.params_from_numpy(tree, device=DEV)
        template = _wire_template(models.make_model(cfg)[0])
        os.environ["HF_HUB_CACHE"] = cache
        roots = {k: os.path.join(tmp, k) for k in ("a", "scan", "serve")}
        try:
            with _ConvertTap(want) as tap:
                miner_extra = ["--max-steps", str(CONVERT_STEPS),
                               "--send-interval", "1e9",
                               "--checkpoint-interval", "0",
                               "--no-anomaly-trace", "--fused-loss"]
                runs = {}
                for name, root, extra in (
                        ("miner", roots["a"], []),
                        ("miner_scan", roots["scan"], ["--scan-blocks"])):
                    t0 = time.perf_counter()
                    run = _lora_cli(miner_cli, _convert_argv(
                        root, "hotkey_1", miner_extra + extra))
                    losses, step_ms, conv = tap.take()
                    what = f"convert {name}"
                    check(run["rc"] == 0, f"{what} CLI exited {run['rc']}")
                    seen = _convert_seen(tap, "miner", what)
                    tap.seen.pop("miner")
                    check(len(losses) == CONVERT_STEPS
                          and all(math.isfinite(x) for x in losses)
                          and losses[-1] < losses[0],
                          f"{what} losses {losses}")
                    check(len(conv) == 1, f"{what}: {len(conv)} conversions")
                    _check_launches(what, run["launches"],
                                    _train_want(cfg, CONVERT_STEPS, True))
                    path = os.path.join(root, "artifacts", "deltas",
                                        "hotkey_1.msgpack")
                    check(os.path.exists(path), f"{what} pushed nothing")
                    with open(path, "rb") as f:
                        data = f.read()
                    delta = flatten_tree(ser.from_msgpack(data, template))
                    check(all(math.isfinite(float(abs(v).max()))
                              for v in delta.values()),
                          f"{what}: the pushed delta is not finite")
                    runs[name] = {**run, "losses": losses,
                                  "step_ms": step_ms,
                                  "step_ms_p50": statistics.median(
                                      step_ms[1:] or step_ms),
                                  "convert_s": conv[0], "first": seen,
                                  "artifact_bytes": len(data),
                                  "data": data}
                    res["times_s"][name] = time.perf_counter() - t0
                u, s = runs["miner"], runs["miner_scan"]
                check(s["first"]["stacked_leading"] == [L]
                      and any(k.startswith("h.block.")
                              for k in s["first"]["state_block_leaves"]),
                      f"convert scan miner: no h.block.* leaves with a "
                      f"leading {L} ({s['first']})")
                check(not u["first"]["stacked_leading"],
                      f"convert miner: stacked leaves ({u['first']})")
                res["scan_losses_max_abs_diff"] = max(
                    abs(a - b) for a, b in zip(u["losses"], s["losses"]))
                check(s["losses"] == u["losses"],
                      f"convert scan miner losses {s['losses']} != the "
                      f"unrolled miner's {u['losses']}")
                check(s.pop("data") == u.pop("data"),
                      "convert scan miner: its pushed bytes differ from "
                      "the unrolled miner's")
                res.update(runs)
                # the validator scores the miner's push on its root
                t0 = time.perf_counter()
                val = _lora_cli(val_cli, _convert_argv(
                    roots["a"], "hotkey_91", ["--rounds", "1"]))
                check(val["rc"] == 0,
                      f"convert validator exited {val['rc']}")
                val["first"] = _convert_seen(tap, "validator", "validator")
                # the base's eval, then the one candidate's, no backward
                _check_launches("convert validator", val["launches"],
                                {"flash_attention_fwd": L * 2 * 2})
                with open(os.path.join(roots["a"], "chain",
                                       "metagraph.json")) as f:
                    weights = json.load(f)["weights"].get("hotkey_91", {})
                check(weights.get("hotkey_1", 0) > 0,
                      f"convert validator weights {weights}")
                val["weight_hotkey_1"] = weights["hotkey_1"]
                res["validator"] = val
                res["times_s"]["validator"] = time.perf_counter() - t0
                # the averager's genesis is the checkpoint; it merges the
                # miner's delta (weighted: the counts are exact)
                t0 = time.perf_counter()
                t_ = LocalFSTransport(os.path.join(roots["a"], "artifacts"))
                avg = _lora_cli(avg_cli, _convert_argv(
                    roots["a"], "hotkey_99", ["--rounds", "1", "--strategy",
                                              "weighted"]))
                check(avg["rc"] == 0, f"convert averager exited {avg['rc']}")
                avg["first"] = _convert_seen(tap, "averager", "averager")
                # the merged base's eval and the genesis base's (the
                # "improved" guard), no backward, no scatter (dense)
                _check_launches("convert averager", avg["launches"],
                                {"flash_attention_fwd": L * 2 * 2})
                check(t_.base_revision() is not None,
                      "convert averager published nothing")
                res["averager"] = avg
                res["times_s"]["averager"] = time.perf_counter() - t0
            # the server on a root with nothing published
            t0 = time.perf_counter()
            res["server"] = _convert_server(roots["serve"], cfg, want)
            res["times_s"]["server"] = time.perf_counter() - t0
        finally:
            if prev is None:
                os.environ.pop("HF_HUB_CACHE", None)
            else:
                os.environ["HF_HUB_CACHE"] = prev
            del want
            _lt_free()
        # run B once this phase's runs have freed the card's memory
        res["text"] = text.finish(cfg)
    return res


def _convert_server(work: str, cfg, want: dict) -> dict:
    """The server CLI with ``--init-from`` on a root where nothing is
    published: it boots on the converted weights (bit-equal to the
    checkpoint's), finishes phase 21's 8 requests, launches exact."""
    import torch
    L = cfg.n_layer
    prompts, bodies = _serve6_traffic(cfg.vocab_size)
    port = _free_port()
    argv = ["--work-dir", work, "--dataset", "synthetic", "--tokenizer",
            "word", "--serve-port", str(port), "--swap-poll", "1",
            "--max-steps", "100000", "--init-from", f"hf:{CONVERT_REPO}"]
    run = _server_cli(argv, port, bodies)
    eng = run["engine"]
    check(eng.revision is None, f"convert server booted on {eng.revision}")
    state = eng.model.state_dict()
    check(state.keys() == want.keys() and all(
        torch.equal(state[k], want[k]) for k in want),
        "convert server: its weights are not the checkpoint's")
    for (code, out), p in zip(run["results"], prompts):
        check(code == 200 and out["status"] == "done"
              and len(out["tokens"]) == 32,
              f"convert server: request not done: {code} {out}")
    dec, win = eng.decode_dispatches, eng.suffix_prefills
    full = eng.full_prefills
    _check_launches("convert server", run["launches"], {
        "paged_decode_attention": L * dec,
        "paged_window_attention": L * (win + eng.verify_dispatches),
        "flash_attention_fwd": L * full})
    check(dec > 0 and full > 0, "convert server: a kernel never ran")
    return {"argv": argv, "rc": run.get("rc"), "boot_s": run["boot_s"],
            "wall_s": run["wall_s"], "launches": run["launches"],
            "dispatches": {"decode": dec, "suffix_prefill": win,
                           "full_prefill": full}}


def convert_child(out: str) -> int:
    """``--convert-child OUT``: phase 29 in a child process, started
    beside the llama children of the whole script; its result as JSON in
    OUT."""
    phase_env()
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    res = phase_convert_roles()
    res["s"] = time.perf_counter() - t0
    log("convert roles:", json.dumps(res, default=str)[:20000])
    with open(out, "w") as f:
        json.dump(res, f, default=str)
    return 0


def _convert_entries(entries: list, conv: dict) -> list:
    """The kernels line's entries with phase 29's launches by CLI."""
    names = ("miner", "miner_scan", "validator", "averager")
    for e in entries:
        counter = ("fused_ce_bwd_dh" if e["name"] == "fused_ce_bwd"
                   else e["name"])
        got = {f"launches_{n}": conv[n]["launches"].get(counter, 0)
               for n in names}
        got["launches_server"] = conv["server"]["launches"].get(counter, 0)
        if any(got.values()):
            e["convert"] = got
        text = conv["text"]
        a = text["a"]["launches"].get(counter, 0)
        b = text["b"]["launches"].get(counter, 0)
        if a or b:
            # phase 29's local-text miner (run A) and its restart on the
            # same build directory (run B)
            e["launches_text"], e["launches_text_restart"] = a, b
    return entries


# ---------------------------------------------------------------------------
# 30. health: the fleet health plane on every role, the lease, --standby
# and --hier sub on a world of two
# ---------------------------------------------------------------------------

HEALTH_MODEL = "gpt2-124m"
HEALTH_BEAT_S = 0.5            # --heartbeat-interval of every role
HEALTH_B, HEALTH_T = 4, 512
HEALTH_PROBE_STEPS = 30        # the miners run alone, with and without beats
HEALTH_VAL_ROUNDS = 7          # round 5 breaches stale_node, 6-7 act on it
HEALTH_DEADLINE_S = 4.0        # the standby's --failover-deadline
HEALTH_LIVE_STEP_S = 0.25      # the live miner's wait before each step
HEALTH_FOLLOW_S = 6.0          # it follows a beating primary this long
HEALTH_TIMEOUT_S = 420.0       # a role process
HEALTH_EVAL = ["--eval-batches", "2", "--eval-seq-len", "512"]


def _health_argv(work: str, hotkey: str, extra: list, *,
                 metrics: str | None = None, beats: bool = True) -> list:
    """A phase 30 role's command line: GPT-2-124M on ``work``'s LocalFS
    root, the flags' ``--heartbeat-interval`` (``beats``) and JSONL sink
    (``metrics``)."""
    return [*DEFAULT_FLAGS, "--backend", "local", "--work-dir", work,
            "--model", HEALTH_MODEL, "--hotkey", hotkey,
            "--no-base-wire-v2", "--no-lineage", "--flight-events", "0",
            "--batch-size", str(HEALTH_B), *HEALTH_EVAL,
            *(["--heartbeat-interval", str(HEALTH_BEAT_S)] if beats else []),
            *(["--metrics-path", metrics] if metrics else []), *extra]


def _health_miner(steps: int, *, send: str = "1e9",
                  pull: str = "1e9") -> list:
    return ["--fused-loss", "--wire-v2", "--seq-len", str(HEALTH_T),
            "--checkpoint-interval", "0", "--no-anomaly-trace",
            "--self-eval-interval", "0", "--log-every", "5",
            "--max-steps", str(steps), "--send-interval", send,
            "--check-update-interval", pull]


class _HealthRole:
    """One role CLI in a process of its own (``--health-role TMP NAME``:
    :func:`health_role`), its output in ``TMP/NAME.log``; ``stop()``
    asks it to end between two steps or rounds (a file it polls)."""

    def __init__(self, tmp: str, name: str, role: str, argv: list,
                 min_step_s: float = 0.0):
        self.tmp, self.name = tmp, name
        with open(os.path.join(tmp, f"{name}.json"), "w") as f:
            json.dump({"role": role, "argv": argv,
                       "min_step_s": min_step_s}, f)
        self.log = open(os.path.join(tmp, f"{name}.log"), "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--health-role",
             tmp, name], stdout=self.log, stderr=subprocess.STDOUT,
            cwd=ROOT)

    def stop(self) -> None:
        open(os.path.join(self.tmp, f"{self.name}.stop"), "w").close()

    def join(self, timeout: float = HEALTH_TIMEOUT_S) -> dict:
        """Wait for the process; its result (return code, launches,
        seconds, what the driver saw). A process that failed fails the
        phase, its log's tail logged first."""
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            self.kill()
        if rc:
            with open(os.path.join(self.tmp, f"{self.name}.log")) as f:
                log(f"--- health {self.name} (exit {rc}):\n"
                    + f.read()[-6000:])
        check(rc == 0, f"health {self.name}: the process exited {rc}")
        with open(os.path.join(self.tmp, f"{self.name}.out.json")) as f:
            out = json.load(f)
        # the CLI's own return code (a stopped role returns 0 too)
        check(out["rc"] == 0, f"health {self.name}: the CLI returned "
              f"{out['rc']}")
        out["wall_s"] = time.perf_counter() - self.t0
        return out

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self.log.close()


def health_role(tmp: str, name: str) -> int:
    """``--health-role TMP NAME``: the role CLI of ``TMP/NAME.json`` in
    this process, the launch counts at 0 before and read after; the
    miner's steps, the validator's candidate-batches, the lease's
    acquires and stamps (with their wall times) and the sink's path
    recorded in ``TMP/NAME.out.json``. ``TMP/NAME.stop`` ends a miner
    before its next step and an averager at its next sleep (a
    KeyboardInterrupt, which the CLIs take as their orderly exit). A
    miner with ``min_step_s`` waits that long before each step (the
    live miner of 30(a) then shares the card with the whole script's
    other phases lightly). A miner also records its first batch's shape
    and visible pairs a head (what phase 31's FLOP count needs) and each
    step's host wall."""
    import importlib
    import torch
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    from distributedtraining_tpu_torch.engine import remediate, scheduler
    from distributedtraining_tpu_torch.engine.train import MinerLoop
    from distributedtraining_tpu_torch.engine.validate import Validator
    with open(os.path.join(tmp, f"{name}.json")) as f:
        spec = json.load(f)
    stop = os.path.join(tmp, f"{name}.stop")
    seen: dict = {"acquire": [], "stamp": 0}

    def stopped():
        if os.path.exists(stop):
            raise KeyboardInterrupt

    train_one = MinerLoop._train_one
    seen["step_wall_ms"] = []

    def _train_one(self, batch):
        stopped()
        time.sleep(spec.get("min_step_s", 0.0))
        if "first_batch" not in seen:
            # the batch the device observatory's cost probe counts
            B, T = batch["input_ids"].shape
            seen["first_batch"] = {
                "B": int(B), "T": int(T), "pairs_per_head": _causal_pairs(
                    B, T, 1, batch["segment_ids"])}
        t0 = time.perf_counter()
        out = train_one(self, batch)
        seen["step_wall_ms"].append((time.perf_counter() - t0) * 1e3)
        return out
    MinerLoop._train_one = _train_one
    flush = MinerLoop.flush

    def _flush(self):
        flush(self)
        seen["steps"] = self.report.steps
        seen["pushes"] = self.report.pushes
    MinerLoop.flush = _flush
    real_sleep = scheduler.RealClock.sleep

    def _sleep(self, seconds):
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            stopped()
            real_sleep(self, min(0.1, end - time.monotonic()))
    scheduler.RealClock.sleep = _sleep
    close = Validator.close

    def _close(self):
        if self._cohort_eval is not None:
            seen["candidate_batches"] = self._cohort_eval.candidate_batches
        return close(self)
    Validator.close = _close
    acquire = remediate.LeaseManager.acquire

    def _acquire(self):
        ok = acquire(self)
        if ok:
            seen["acquire"].append({"t": time.time(), "epoch": self.epoch})
        return ok
    remediate.LeaseManager.acquire = _acquire
    stamp = remediate.LeaseManager.stamp

    def _stamp(self, rev):
        seen["stamp"] += 1
        return stamp(self, rev)
    remediate.LeaseManager.stamp = _stamp
    module = importlib.import_module(
        f"distributedtraining_tpu_torch.neurons.{spec['role']}")
    _lt_zero()
    t0 = time.perf_counter()
    rc = module.main(spec["argv"])
    if DEV == "cuda":
        torch.cuda.synchronize()
    with open(os.path.join(tmp, f"{name}.out.json"), "w") as f:
        json.dump({"rc": rc, "s": time.perf_counter() - t0,
                   "launches": _lt_launches(), **seen}, f)
    return 0


def _text_taps(seen: dict):
    """Phase 29's taps on a text run's miner CLI: each step's loss and
    the largest input id of its batch, the tokenizer and the corpora the
    build chose, every library build's seconds (0.0: found built) and
    every compiler run. Returns the function that takes them off."""
    from distributedtraining_tpu_torch import native
    from distributedtraining_tpu_torch.data import datasets
    from distributedtraining_tpu_torch.engine.train import MinerLoop
    from distributedtraining_tpu_torch.neurons import common
    from distributedtraining_tpu_torch.ops import _cuda
    seen.update(losses=[], ids_max=0, builds=[], compiled=[], corpora=[])
    undo = []

    def tap(owner, name, make):
        real = getattr(owner, name)
        undo.append((owner, name, real))
        setattr(owner, name, make(real))

    def train_one(real):
        def run(self, batch):
            seen["ids_max"] = max(seen["ids_max"],
                                  int(batch["input_ids"].max()))
            m = real(self, batch)
            seen["losses"].append(float(m["loss"]))
            return m
        return run

    def timed(record):
        def make(real):
            def run(*a, **kw):
                t0 = time.perf_counter()
                out = real(*a, **kw)
                record(a, out, time.perf_counter() - t0)
                return out
            return run
        return make

    def text_corpus(real):
        def run(**kw):
            docs = real(**kw)
            synth = datasets.text_corpus(**{**kw, "source": "synthetic"})
            seen["corpora"].append({
                "split": kw.get("split", "train"),
                "source": kw.get("source"), "n_docs": len(docs),
                "resolved": ("synthetic" if docs == synth else "files"
                             if str(kw.get("source")).startswith("files:")
                             else "wikitext")})
            return docs
        return run

    tap(MinerLoop, "_train_one", train_one)
    for owner, kind in ((_cuda, "cuda"), (native, "host")):
        tap(owner, "build", timed(lambda a, out, _s, kind=kind: seen[
            "builds"].append({"name": a[0], "kind": kind, "s": out})))
    tap(_cuda, "compile_atomic", timed(lambda a, out, secs: seen[
        "compiled"].append({"library": os.path.basename(str(a[1])),
                            "dir": os.path.dirname(str(a[1])),
                            "s": secs})))
    tap(common, "build_tokenizer", timed(lambda a, tok, _s: seen.update(
        tokenizer={"class": type(tok).__name__,
                   "vocab_size": tok.vocab_size})))
    tap(common, "text_corpus", text_corpus)

    def off():
        for owner, name, real in reversed(undo):
            setattr(owner, name, real)
    return off


def _health_jsonl(path: str) -> list:
    from distributedtraining_tpu_torch.utils.metrics import jsonl_segments
    out = []
    for seg in jsonl_segments(path):
        if os.path.exists(seg):
            with open(seg) as f:
                out += [json.loads(line) for line in f]
    return out


def _health_avg_want(L: int, recs: list) -> dict:
    """An averager's launches from its own records: each merge's
    evaluation (flash forward, layers x eval batches; ``always``
    evaluates no base) and one scatter a packed contribution folded."""
    merges = [r for r in recs if "merged_loss" in r]
    return {"flash_attention_fwd": L * 2 * len(merges),
            "dequant_scatter": sum(r["accepted"] for r in merges)}


def _health_wait(pred, what: str, timeout: float = 240.0,
                 every: float = 0.2):
    t0 = time.perf_counter()
    while True:
        got = pred()
        if got:
            return got
        check(time.perf_counter() - t0 < timeout,
              f"health: waited {timeout} s for {what}")
        time.sleep(every)


def _health_beat_cost(t) -> dict:
    """A miner's beat on this card's process: the vitals' collection
    (the allocator's counters, no synchronisation) and the upload through
    the LocalFS rider channel, host ms over 50 beats, and its bytes."""
    import torch
    from distributedtraining_tpu_torch.engine.health import (
        HeartbeatPublisher, report_vitals)
    from distributedtraining_tpu_torch.engine.train import MinerReport
    torch.zeros(1, device=DEV)   # a live context, as a role has
    rep = MinerReport(steps=100, pushes=3, last_loss=3.25)
    pub = HeartbeatPublisher(t, "miner", "hotkey_77", interval=60,
                             vitals=report_vitals(
                                 rep, base_revision=lambda: "r" * 64))
    try:
        body_ms, beat_ms = [], []
        for i in range(50):
            rep.steps += 10
            t0 = time.perf_counter()
            body = pub._body()
            body_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            pub.beat_now(wait=True)
            beat_ms.append((time.perf_counter() - t0) * 1e3)
        check(pub.sent == 50 and pub.failed == 0,
              f"health beat cost: sent {pub.sent}, failed {pub.failed}")
        check(DEV != "cuda" or "mem_peak_bytes" in body,
              f"health beat: no device memory in the body {body}")
        return {"collect_ms_p50": statistics.median(body_ms),
                "beat_ms_p50": statistics.median(beat_ms),
                "bytes": len(json.dumps(body)),
                "fields": sorted(body)}
    finally:
        pub.close()


def _health_world1(work: str, tmp: str, cfg, *,
                   probe_pair: bool = True) -> dict:
    """30(a): two miners, a ``--remediate`` validator, a ``--remediate``
    primary averager and a ``--standby`` on one root, at most three role
    processes at once (see the module docstring). Without
    ``probe_pair`` the miner without beats (a measurement that
    ``--beat-ab`` makes in full) is not run."""
    import math
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.engine.health import parse_heartbeat
    from distributedtraining_tpu_torch.engine.remediate import parse_lease
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    from distributedtraining_tpu_torch.transport.base import (heartbeat_id,
                                                              lease_id)
    L = cfg.n_layer
    t = LocalFSTransport(os.path.join(work, "artifacts"))
    res: dict = {"times_s": {}}
    t0 = time.perf_counter()
    genesis = t.publish_base(models.init_params_numpy(cfg, SEED))
    res["times_s"]["genesis"] = time.perf_counter() - t0
    # a metagraph of the two miners and the validator: the validator's
    # cohort is then the fleet's (2 miners), and shrinks with quarantine
    os.makedirs(os.path.join(work, "chain"), exist_ok=True)
    with open(os.path.join(work, "chain", "metagraph.json"), "w") as f:
        json.dump({"hotkeys": ["hotkey_1", "hotkey_2", "hotkey_91"],
                   "uids": [1, 2, 91], "stakes": [10.0, 10.0, 10000.0],
                   "weights": {}, "ema_scores": {}}, f)
    res["beat"] = _health_beat_cost(t)
    jl = {k: os.path.join(tmp, f"{k}.jsonl")
          for k in ("m0", "m2", "m1", "val", "p", "s")}
    runs: dict = {}

    def miner(name, hotkey, beats, steps, min_step_s=0.0, **kw):
        return _HealthRole(tmp, name, "miner", _health_argv(
            work, hotkey, _health_miner(steps, **kw), metrics=jl[name],
            beats=beats), min_step_s=min_step_s)

    # the miner's step alone, without and with beats (the same flags)
    for name, hotkey, beats in (("m0", "hotkey_3", False),
                                ("m2", "hotkey_2", True)):
        if beats or probe_pair:
            runs[name] = miner(name, hotkey, beats,
                               HEALTH_PROBE_STEPS).join()
    # hotkey_2 stopped after its first push: its last beat is its exit's
    hb2 = parse_heartbeat(t.fetch_delta_meta(heartbeat_id("miner",
                                                          "hotkey_2")))
    check(hb2 is not None and hb2["steps"] == HEALTH_PROBE_STEPS
          and hb2["pushes"] == 1.0 and runs["m2"]["pushes"] == 1,
          f"health: hotkey_2's last beat {hb2}")
    # the primary (lease epoch 1 at boot) and the live miner
    prim = _HealthRole(tmp, "p", "averager", _health_argv(
        work, "hotkey_95", ["--remediate", "--strategy", "weighted",
                            "--publish-policy", "always", "--rounds",
                            "100000", "--averaging-interval", "5"],
        metrics=jl["p"]))
    m1 = miner("m1", "hotkey_1", True, 10**7, min_step_s=HEALTH_LIVE_STEP_S,
               send="4", pull="2")
    val = sb = None
    try:
        _health_wait(lambda: t.delta_revision("hotkey_1") is not None
                     and (parse_lease(t.fetch_delta_meta(lease_id()))
                          or {}).get("base_revision") not in (None,
                                                              genesis),
                     "hotkey_1's first push and the primary's publish")
        val = _HealthRole(tmp, "val", "validator", _health_argv(
            work, "hotkey_91", ["--remediate", "--rounds",
                                str(HEALTH_VAL_ROUNDS),
                                "--validation-interval", "2",
                                "--val-cohort", "8"], metrics=jl["val"]))
        runs["val"] = val.join()
        # the standby follows the beating primary past its deadline
        sb = _HealthRole(tmp, "s", "averager", _health_argv(
            work, "hotkey_96", ["--standby", "--failover-deadline",
                                str(HEALTH_DEADLINE_S), "--strategy",
                                "weighted", "--publish-policy", "always",
                                "--rounds", "2", "--averaging-interval",
                                "4"], metrics=jl["s"]))
        _health_wait(lambda: t.fetch_delta_meta(
            heartbeat_id("averager", "hotkey_96")) is not None,
            "the standby's first beat")
        time.sleep(HEALTH_FOLLOW_S)
        lease = parse_lease(t.fetch_delta_meta(lease_id()))
        check(lease["epoch"] == 1 and lease["holder"] == "hotkey_95",
              f"health: the standby took {lease} while the primary beat")
        prim.stop()
        runs["p"] = prim.join()
        p_last = parse_heartbeat(t.fetch_delta_meta(
            heartbeat_id("averager", "hotkey_95")))
        p_lease = parse_lease(t.fetch_delta_meta(lease_id()))
        runs["s"] = sb.join()
        m1.stop()
        runs["m1"] = m1.join()
    finally:
        for r in (prim, m1, val, sb):
            if r is not None:
                r.kill()
    # the miners: launches exact, losses finite
    for name in [m for m in ("m0", "m2", "m1") if m in runs]:
        r = runs[name]
        _check_launches(f"health {name}", r["launches"],
                        {**_train_want(cfg, r["steps"], True)})
        recs = _health_jsonl(jl[name])
        losses = [x["train_loss"] for x in recs if "train_loss" in x]
        check(losses and all(math.isfinite(x) for x in losses),
              f"health {name}: losses {losses[:8]}")
        reg = [x for x in recs if x.get("obs_registry") == "miner"][-1]
        r["step_ms_p50"] = reg["miner.step_ms.p50"]
        r["records"] = len(recs)
    res["miner_step_ms_p50"] = {
        "no_beats": runs["m0"]["step_ms_p50"] if "m0" in runs else None,
        "beats": runs["m2"]["step_ms_p50"]}
    # the validator: the stale miner's breach, quarantine, decayed score
    # and the shrunken cohort, from its JSONL
    recs = _health_jsonl(jl["val"])
    breaches = [(x["slo_breach"], x["hotkey"], x["round"]) for x in recs
                if "slo_breach" in x]
    actions = [(x["remediation"], x["hotkey"]) for x in recs
               if "remediation" in x]
    rounds = [x["round_scores"] for x in recs if "round_scores" in x]
    ledgers = [x["fleet_ledger"] for x in recs if "fleet_ledger" in x]
    cohort = [x["val.effective_cohort"] for x in recs
              if x.get("obs_registry") == "validator"
              and "val.effective_cohort" in x]
    # each round's torn wire-v2 reads (the registry flush after its
    # round record): a live miner's publish can land between the
    # validator's manifest and shard reads, which reads as a counted,
    # transient no_delta (JAX engine/ingest.py's rule too)
    torn = [x.get("wire.torn_fetches", 0.0) for x in recs
            if x.get("obs_registry") == "validator"]
    torn = [b - a for a, b in zip([0.0] + torn, torn)]
    log("health validator:", json.dumps({
        "breaches": breaches, "actions": actions, "torn_reads": torn,
        "reasons": [{h: v["reason"] for h, v in r.items()} for r in rounds],
        "scores_hotkey_2": [lg.get("miner/hotkey_2", {}).get("score")
                            for lg in ledgers],
        "effective_cohort": cohort}))
    check(("stale_node", "hotkey_2", 5) in breaches
          and ("stale_node", "hotkey_1") not in [b[:2] for b in breaches],
          f"health validator: breaches {breaches}")
    check(actions == [("quarantined", "hotkey_2")],
          f"health validator: actions {actions}")
    check(len(rounds) == HEALTH_VAL_ROUNDS and len(torn) >= len(rounds)
          and all(r["hotkey_2"]["reason"] == "quarantined"
                  and r["hotkey_2"]["score"] == 0.0 for r in rounds[5:])
          and all(r["hotkey_1"]["reason"] == "ok"
                  or (r["hotkey_1"]["reason"] == "no_delta" and t > 0)
                  for r, t in zip(rounds, torn)),
          f"health validator: round scores {rounds}, torn reads a round "
          f"{torn}")
    check(ledgers[-1]["miner/hotkey_2"]["quarantined"] == 1
          and ledgers[-1]["miner/hotkey_2"]["score"] == 0.0,
          f"health validator: hotkey_2's ledger {ledgers[-1]}")
    check(cohort[:4] == [2.0] * 4 and cohort[-1] == 1.0,
          f"health validator: the effective cohort {cohort}")
    r = runs["val"]
    _check_launches("health validator", r["launches"], {
        "flash_attention_fwd": L * r["candidate_batches"]})
    res["validator"] = {"breaches": breaches, "actions": actions,
                        "effective_cohort": cohort,
                        "hotkey_2_scores": [
                            lg.get("miner/hotkey_2", {}).get("score")
                            for lg in ledgers],
                        "candidate_batches": r["candidate_batches"],
                        "launches": r["launches"], "s": r["s"]}
    # the primary held epoch 1, the standby took epoch 2 within the
    # deadline plus one poll of the primary's last signal, and every
    # published base has one holder
    prec, srec = _health_jsonl(jl["p"]), _health_jsonl(jl["s"])
    pub_p = [x for x in prec if x.get("published") == 1]
    pub_s = [x for x in srec if x.get("published") == 1]
    acq_p, acq_s = runs["p"]["acquire"], runs["s"]["acquire"]
    last = max(p_last["t"], p_lease["t"])
    poll_s = 1.0     # max(1, min(--averaging-interval / 4, 30))
    takeover_s = acq_s[0]["t"] - last if acq_s else None
    log("health failover:", json.dumps({
        "primary_acquires": acq_p, "standby_acquires": acq_s,
        "primary_published": [(x["base_revision"], x["lease_epoch"])
                              for x in pub_p],
        "standby_published": [(x["base_revision"], x["lease_epoch"])
                              for x in pub_s],
        "takeover_s": takeover_s}))
    check([a["epoch"] for a in acq_p] == [1] and runs["p"]["stamp"]
          == len(pub_p) >= 1 and all(x["lease_epoch"] == 1 for x in pub_p),
          f"health primary: acquires {acq_p}, stamps {runs['p']['stamp']}"
          f", published {len(pub_p)}")
    check([a["epoch"] for a in acq_s] == [2] and runs["s"]["stamp"]
          == len(pub_s) >= 1 and all(x["lease_epoch"] == 2 for x in pub_s),
          f"health standby: acquires {acq_s}, stamps {runs['s']['stamp']}"
          f", published {len(pub_s)}")
    check(HEALTH_DEADLINE_S <= takeover_s
          <= HEALTH_DEADLINE_S + poll_s + HEALTH_BEAT_S + 0.5,
          f"health standby: took over {takeover_s} s after the primary's "
          f"last signal (deadline {HEALTH_DEADLINE_S}, poll {poll_s})")
    revs = [x["base_revision"] for x in pub_p + pub_s]
    check(len(set(revs)) == len(revs)
          and all(x["ts"] < acq_s[0]["t"] for x in pub_p),
          "health: a base was published twice or by the primary after "
          "the takeover")
    final = parse_lease(t.fetch_delta_meta(lease_id()))
    check(final["epoch"] == 2 and final["holder"] == "hotkey_96"
          and final["base_revision"] == t.base_revision()
          == pub_s[-1]["base_revision"],
          f"health: the final token {final}, base {t.base_revision()}")
    for name, recs_ in (("p", prec), ("s", srec)):
        _check_launches(f"health averager {name}", runs[name]["launches"],
                        _health_avg_want(L, recs_))
    res["averager"] = {
        "primary": {"published": len(pub_p), "acquires": acq_p,
                    "launches": runs["p"]["launches"]},
        "standby": {"published": len(pub_s), "acquires": acq_s,
                    "launches": runs["s"]["launches"],
                    "takeover_s": takeover_s}}
    res["runs"] = {k: {kk: v for kk, v in r.items()
                       if kk in ("rc", "s", "wall_s", "steps", "pushes",
                                 "launches", "step_ms_p50")}
                   for k, r in runs.items()}
    return res


def _health_root(work: str, cfg, n_deltas: int = 2, seed: int = 1) -> str:
    """A root with the genesis base and ``n_deltas`` dense deltas on it
    (numpy, from ``seed``); its revision."""
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    t = LocalFSTransport(os.path.join(work, "artifacts"))
    base = models.init_params_numpy(cfg, SEED)
    rev = t.base_revision() or t.publish_base(base)
    _health_deltas(t, base, rev, n_deltas, seed)
    return rev


def _health_deltas(t, base, rev, n: int, seed: int) -> None:
    import numpy as np
    rng = np.random.default_rng(seed)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                (rng.standard_normal(np.shape(v)) * 1e-4).astype(np.float32)
                for k, v in tree.items()}
    for i in range(n):
        h = f"hotkey_{i + 1}"
        t.publish_delta(h, draw(base))
        t.publish_delta_meta(h, {"base_revision": rev})


def _health_world2(tmp: str, cfg) -> dict:
    """30(b): the same roles on a world of two over gloo (both ranks on
    this card): a ``--remediate`` primary, a ``--standby`` behind it, and
    a ``--hier sub`` whose aggregate's bytes are the one-process node's."""
    import shutil
    import torch
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.engine.remediate import parse_lease
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    from distributedtraining_tpu_torch.transport.base import lease_id
    L = cfg.n_layer
    res: dict = {}
    work = os.path.join(tmp, "w2")
    _health_root(work, cfg)
    t = LocalFSTransport(os.path.join(work, "artifacts"))
    avg = ["--strategy", "weighted", "--publish-policy", "always",
           "--rounds", "1"]
    outs = _mr_cli(2, "gloo", "averager", _health_argv(
        work, "hotkey_95", avg + ["--remediate"]), "health w2 primary")
    res["primary"] = outs
    check([o["rc"] for o in outs] == [0, 0]
          and [o["counts"].get("acquire", 0) for o in outs] == [1, 0]
          and [o["counts"].get("stamp", 0) for o in outs] == [1, 0]
          and [o["counts"].get("publish_base", 0) for o in outs] == [1, 0],
          f"health w2 primary: {outs}")
    for r, o in enumerate(outs):
        _check_launches(f"health w2 primary rank {r}", o["launches"],
                        {"flash_attention_fwd": L * 2})
    lease = parse_lease(t.fetch_delta_meta(lease_id()))
    check(lease["epoch"] == 1 and lease["base_revision"]
          == t.base_revision(), f"health w2 primary: token {lease}")
    # fresh submissions on the primary's base; the primary is gone
    _health_deltas(t, models.init_params_numpy(cfg, SEED),
                   t.base_revision(), 2, 2)
    outs = _mr_cli(2, "gloo", "averager", _health_argv(
        work, "hotkey_96", ["--strategy", "weighted", "--publish-policy",
                            "always", "--rounds", "1", "--standby",
                            "--failover-deadline", "2",
                            "--averaging-interval", "4"]),
        "health w2 standby")
    res["standby"] = outs
    check([o["rc"] for o in outs] == [0, 0]
          and [o["counts"].get("acquire", 0) for o in outs] == [1, 0]
          and [o["counts"].get("stamp", 0) for o in outs] == [1, 0]
          and [o["counts"].get("publish_base", 0) for o in outs] == [1, 0],
          f"health w2 standby: {outs}")
    for r, o in enumerate(outs):
        _check_launches(f"health w2 standby rank {r}", o["launches"],
                        {"flash_attention_fwd": L * 2})
    lease = parse_lease(t.fetch_delta_meta(lease_id()))
    check(lease["epoch"] == 2 and lease["holder"] == "hotkey_96"
          and lease["base_revision"] == t.base_revision(),
          f"health w2 standby: token {lease}")
    # --hier sub: a world of two against one process, on copies of a root
    # of two dense deltas and an int8 wire-v2 one, which both fold packed
    # (one scatter launch a process or rank)
    sub = ["--hier", "sub", "--hier-node", "n0", "--hier-nodes", "n0",
           "--remediate", "--rounds", "1"]
    roots = {k: os.path.join(tmp, f"sub_{k}") for k in ("w1", "w2")}
    rev = _health_root(roots["w1"], cfg, seed=3)
    g = torch.Generator(device=DEV).manual_seed(SEED + 30)
    _publish_packed(
        LocalFSTransport(os.path.join(roots["w1"], "artifacts")),
        "hotkey_3", {k: torch.randn(v.shape, generator=g, device=DEV)
                     * 1e-4 for k, v in models.gpt2.params_from_numpy(
                         models.init_params_numpy(cfg, SEED),
                         device=DEV).items()}, rev, "int8")
    shutil.copytree(roots["w1"], roots["w2"])
    one = _HealthRole(tmp, "sub_w1", "averager",
                      _health_argv(roots["w1"], "hotkey_97", sub,
                                   beats=False)).join()
    outs = _mr_cli(2, "gloo", "averager", _health_argv(
        roots["w2"], "hotkey_97", sub), "health w2 sub")
    res["sub"] = {"world1": one, "world2": outs}
    check(one["rc"] == 0 and [o["rc"] for o in outs] == [0, 0]
          and [o["counts"].get("acquire", 0) for o in outs] == [1, 0]
          and [o["counts"].get("stamp", 0) for o in outs] == [1, 0],
          f"health w2 sub: {one}, {outs}")
    _check_launches("health w1 sub", one["launches"],
                    {"dequant_scatter": 1})
    for r, o in enumerate(outs):
        _check_launches(f"health w2 sub rank {r}", o["launches"],
                        {"dequant_scatter": 1})
    for name in ("__agg__.n0.msgpack", "__agg__.n0.meta.json"):
        with open(os.path.join(roots["w1"], "artifacts", "deltas",
                               name), "rb") as f:
            a = f.read()
        with open(os.path.join(roots["w2"], "artifacts", "deltas",
                               name), "rb") as f:
            b = f.read()
        check(a == b, f"health w2 sub: {name} differs from world 1's")
        res["sub"][f"bytes_{name}"] = len(a)
    return res


def phase_health(probe_pair: bool = True) -> dict:
    """Phase 30 (see the module docstring); ``probe_pair`` as
    :func:`_health_world1` takes it."""
    import tempfile
    from distributedtraining_tpu_torch import models
    cfg = models.gpt2.PRESETS[HEALTH_MODEL]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_lora_work_root()) as tmp:
        work = os.path.join(tmp, "w1")
        res = {"world1": _health_world1(work, tmp, cfg,
                                        probe_pair=probe_pair)}
        res["world1"]["s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        res["world2"] = _health_world2(tmp, cfg)
        res["world2"]["s"] = time.perf_counter() - t1
    res["s"] = time.perf_counter() - t0
    return res


def health_child(out: str) -> int:
    """``--health-child OUT``: phase 30 in a child process (in the whole
    script after phase 29's, beside the llama chain), without the
    no-beats probe miner; its result as JSON in OUT."""
    phase_env()
    sys.path.insert(0, ROOT)
    res = phase_health(probe_pair=False)
    log("health:", json.dumps(res, default=str)[:20000])
    with open(out, "w") as f:
        json.dump(res, f, default=str)
    return 0


def health_only() -> int:
    """``--health``: phase 30 alone after the build; the ``health`` line,
    the card's line and the result line."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    phase_build()
    res = phase_health()
    print(json.dumps({"health": {**res, "card": card}}, default=str),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


HEALTH_AB_STEPS = 40            # --beat-ab: steps of one in-process block
# --beat-ab's in-process sides: no beats, phase 30's interval, 10x as many
HEALTH_AB_SIDES = {"off": None, "on": HEALTH_BEAT_S,
                   "on_x10": HEALTH_BEAT_S / 10}


def _beat_ab_blocks(cfg, rounds: int) -> dict:
    """The in-process half of :func:`beat_ab`: blocks of HEALTH_AB_STEPS
    fused-loss steps with each side of HEALTH_AB_SIDES (no publisher, or
    a HeartbeatPublisher beating at its interval), one block of each side
    a round, the sides' order rotated each round."""
    import tempfile
    import torch
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.engine.health import (
        HeartbeatPublisher, report_vitals)
    from distributedtraining_tpu_torch.engine.train import (MinerReport,
                                                            TrainEngine)
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    tok = _tokenizer()
    batches = _batches(tok, split="train", batch_size=HEALTH_B,
                       seq_len=HEALTH_T, n=HEALTH_AB_STEPS)
    eng = TrainEngine(gpt2.make_model(cfg)[0], fused_loss=True, device=DEV)
    state = eng.init_state(gpt2.params_from_numpy(
        models.init_params_numpy(cfg, SEED), device=DEV))
    sync = torch.cuda.synchronize if DEV == "cuda" else (lambda: None)
    rep = MinerReport()
    sides = list(HEALTH_AB_SIDES)
    out: dict = {side: [] for side in sides}
    out["order"] = []
    with tempfile.TemporaryDirectory(dir=_lora_work_root()) as tmp:
        t = LocalFSTransport(os.path.join(tmp, "artifacts"))

        def block(interval) -> dict:
            nonlocal state
            pub = None
            if interval is not None:
                pub = HeartbeatPublisher(
                    t, "miner", "hotkey_ab", interval=interval,
                    vitals=report_vitals(rep, base_revision=lambda: "r"))
                pub.start()
            sync()
            step_ms = []
            t_all = time.perf_counter()
            for i, batch in enumerate(batches):
                t0 = time.perf_counter()
                state, m = eng.train_step(state, eng.place_batch(batch))
                step_ms.append((time.perf_counter() - t0) * 1e3)
                rep.steps += 1
                if (i + 1) % 5 == 0:
                    # the miner's read of its loss at --log-every 5
                    rep.last_loss = float(m["loss"])
            sync()
            wall_ms = (time.perf_counter() - t_all) * 1e3
            sent = 0
            if pub is not None:
                pub.close()
                sent = pub.sent
                check(pub.failed == 0 and sent >= 1,
                      f"beat-ab: {sent} beats sent, {pub.failed} failed")
            return {"step_ms_p50": statistics.median(step_ms),
                    "ms_per_step": wall_ms / len(batches), "beats": sent}

        block(None)   # warm-up: the kernels' first launches
        for r in range(rounds):
            k = r % len(sides)
            for side in sides[k:] + sides[:k]:
                out["order"].append(side)
                out[side].append(block(HEALTH_AB_SIDES[side]))
    return out


def _beat_ab_cli(cfg, pairs: int) -> dict:
    """The process half of :func:`beat_ab`: phase 30's probe miner CLI
    (30 ``--fused-loss --wire-v2`` steps) without and with
    ``--heartbeat-interval``, alternating, one process at a time."""
    import tempfile
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    out: dict = {"off": [], "on": [], "order": []}
    with tempfile.TemporaryDirectory(dir=_lora_work_root()) as tmp:
        work = os.path.join(tmp, "w")
        LocalFSTransport(os.path.join(work, "artifacts")).publish_base(
            models.init_params_numpy(cfg, SEED))
        for i, beats in enumerate(
                ([False, True, True, False] * pairs)[:2 * pairs]):
            name = f"ab{i}"
            jl = os.path.join(tmp, f"{name}.jsonl")
            r = _HealthRole(tmp, name, "miner", _health_argv(
                work, f"hotkey_{60 + i}", _health_miner(HEALTH_PROBE_STEPS),
                metrics=jl, beats=beats)).join()
            recs = _health_jsonl(jl)
            reg = [x for x in recs if x.get("obs_registry") == "miner"][-1]
            out["order"].append("on" if beats else "off")
            out["on" if beats else "off"].append(
                {"step_ms_p50": reg["miner.step_ms.p50"],
                 "s": r["s"], "wall_s": r["wall_s"]})
    return out


def beat_ab(argv: list) -> int:
    """``--beat-ab [ROUNDS [CLI_PAIRS]]``: a heartbeat's cost on the
    miner's step at GPT-2-124M (phase 30's miners: ``--fused-loss``, B 4
    x T 512). In one process: ROUNDS rounds (default 12) of one block of
    HEALTH_AB_STEPS engine steps for each side of HEALTH_AB_SIDES (no
    beats; a HeartbeatPublisher with the miner's vitals on its own
    thread every 0.5 s, phase 30's interval; and every 0.05 s, to scale
    any cost a beat has by ten), the sides' order rotated each round so
    that none always runs first; each block's step p50 (the host wall of
    ``train_step``, as ``miner.step_ms`` reads it, with the loss read
    every 5 steps as the miner reads it) and its ms a step between two
    synchronisations. Then CLI_PAIRS pairs (default 6) of phase 30's
    probe miner CLI without and with ``--heartbeat-interval 0.5``, one
    process each, in the order off, on, on, off, ... One ``beat_ab``
    line, the card's line. No claim."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    from distributedtraining_tpu_torch import models
    rounds = int(argv[0]) if argv else 12
    cli_pairs = int(argv[1]) if len(argv) > 1 else 6
    check(rounds >= 1 and cli_pairs >= 0,
          f"--beat-ab: {rounds} rounds, {cli_pairs} CLI pairs")
    phase_build()
    cfg = models.gpt2.PRESETS[HEALTH_MODEL]
    res = {"in_process": _beat_ab_blocks(cfg, rounds)}
    if cli_pairs:
        res["cli"] = _beat_ab_cli(cfg, cli_pairs)
    for part in res.values():
        for side in sorted(set(part["order"])):
            part[f"{side}_step_ms_p50_median"] = statistics.median(
                b["step_ms_p50"] for b in part[side])
            if "ms_per_step" in part[side][0]:
                part[f"{side}_ms_per_step_median"] = statistics.median(
                    b["ms_per_step"] for b in part[side])
    print(json.dumps({"beat_ab": {**res, "card": card}}), flush=True)
    print(card, flush=True)
    return 0


def _health_entries(entries: list, health: dict) -> list:
    """The kernels line's entries with phase 30's launches by role
    process (world 1) and by rank (world 2)."""
    w1 = health["world1"]["runs"]
    w2 = health["world2"]
    for e in entries:
        counter = ("fused_ce_bwd_dh" if e["name"] == "fused_ce_bwd"
                   else e["name"])
        got = {f"launches_{n}": r["launches"].get(counter, 0)
               for n, r in w1.items()}
        for n in ("primary", "standby"):
            got[f"launches_w2_{n}"] = [o["launches"].get(counter, 0)
                                       for o in w2[n]]
        got["launches_w2_sub"] = [o["launches"].get(counter, 0)
                                  for o in w2["sub"]["world2"]]
        got["launches_w1_sub"] = w2["sub"]["world1"]["launches"].get(
            counter, 0)
        if any(v if isinstance(v, int) else any(v) for v in got.values()):
            e["health"] = got
    return entries


# ---------------------------------------------------------------------------
# 31. obs: the device observatory (devprof), the --obs-port exporter with
# /debug/profile, and --chaos-spec, at GPT-2-124M
# ---------------------------------------------------------------------------

OBS_STEPS = 400                # the scraped miner's bound; stopped earlier
OBS_PROFILE_MS = 300           # the /debug/profile capture
OBS_AB_STEPS = 30              # 31(d)'s miners
OBS_FLOPS_TOL = 0.05           # train.step's FLOPs against the analytic
# 31(c), the chaos round of tests/test_torch_chaos.py (CHAOS_SPEC and
# CHAOS_ROUND there): its faults are a function of the seed and of the
# transport calls, which do not depend on the model's size or device
OBS_CHAOS_SPEC = {"seed": 3, "fetch_error_rate": 0.2,
                  "partitioned": ["hotkey_2"]}
OBS_CHAOS_ROUND = {
    "verdicts": {"hotkey_1": "ok", "hotkey_2": "fetch_error"},
    "positive": ["hotkey_1"],
    "chaos": {"hotkey_1": {},
              "hotkey_2": {"chaos.faults": 3.0,
                           "chaos.partition_faults": 3.0},
              "validator": {"chaos.faults": 28.0,
                            "chaos.fetch_faults": 23.0,
                            "chaos.partition_faults": 5.0}},
}


def _obs_get(port: int, path: str, timeout: float = 60.0):
    """``(status, body text, seconds)`` of one GET (an HTTP error's
    status and body too)."""
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            body, code = r.read().decode(), r.status
    except urllib.error.HTTPError as e:
        body, code = e.read().decode(), e.code
    return code, body, time.perf_counter() - t0


def _obs_prog(recs: list, prog: str) -> dict:
    """The last ``{"devprof"}`` record's entry of ``prog`` (the busiest
    bucket)."""
    dp = [r for r in recs if "devprof" in r]
    check(dp, f"obs: no devprof record in the JSONL for {prog}")
    got = [p for p in dp[-1]["devprof"]["programs"] if p["prog"] == prog]
    check(got, f"obs: no {prog} in the last devprof record")
    return max(got, key=lambda p: p["calls"])


def _obs_analytic_flops(cfg, fb: dict) -> dict:
    """train.step's FLOPs by hand for the first batch: per block the four
    projections (12 E^2 weights) forward and both backward products (6 N
    a weight), the flash kernels' count (4 + 8 + 6 = 18 D FLOPs a
    visible pair and head), and the fused CE (forward 2, backward 6 N V
    E over the N (T - 1) shifted rows and the padded vocabulary)."""
    B, T, L, E = fb["B"], fb["T"], cfg.n_layer, cfg.n_embd
    H, D = cfg.n_head, cfg.n_embd // cfg.n_head
    V = -(-cfg.vocab_size // cfg.vocab_multiple) * cfg.vocab_multiple
    parts = {"matmuls": L * 6 * B * T * 12 * E * E,
             "attention": L * 18 * D * H * fb["pairs_per_head"],
             "ce": 8 * B * (T - 1) * V * E}
    return {**parts, "total": sum(parts.values())}


def _obs_trace_names(path: str) -> set:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def _obs_miner(tmp: str, cfg) -> dict:
    """31(a): the miner CLI with ``--metrics-path``, ``--obs-port`` and
    beats, scraped while it trains, then stopped."""
    import concurrent.futures as cf
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    from distributedtraining_tpu_torch.transport.base import heartbeat_id
    work = os.path.join(tmp, "a")
    LocalFSTransport(os.path.join(work, "artifacts")).publish_base(
        models.init_params_numpy(cfg, SEED))
    port, jl = _free_port(), os.path.join(tmp, "a.jsonl")
    role = _HealthRole(tmp, "obs_miner", "miner", _health_argv(
        work, "hotkey_1", _health_miner(OBS_STEPS) + [
            "--obs-port", str(port)], metrics=jl))
    res: dict = {"port": port}
    try:
        def ten_steps():
            try:
                code, body, _ = _obs_get(port, "/metrics", 5)
            except OSError:
                check(role.proc.poll() is None,
                      "obs miner exited before its tenth step")
                return None
            m = re.search(r"^dt_miner_step_ms_count (\S+)$", body, re.M)
            return code == 200 and m and float(m.group(1)) >= 10
        _health_wait(ten_steps, "the obs miner's tenth step on /metrics")
        code, body, res["scrape_s"] = _obs_get(port, "/metrics")
        check(code == 200 and 'dt_prog_calls{prog="train.step",bucket='
              f'"{HEALTH_B}x{HEALTH_T}"}}' in body,
              f"obs: /metrics {code} without train.step's series")
        res["metrics_lines"] = len(body.splitlines())
        res["metrics_prog_lines"] = [ln for ln in body.splitlines()
                                     if ln.startswith("dt_prog_")]
        code, body, _ = _obs_get(port, "/healthz")
        res["healthz"] = json.loads(body)
        check(code == 200 and res["healthz"]["ok"]
              and res["healthz"]["role"] == "miner",
              f"obs: /healthz {code} {body}")
        code, body, _ = _obs_get(port, "/debug/stacks")
        check(code == 200 and f"obs-http-{port}" in body,
              f"obs: /debug/stacks {code}")
        with cf.ThreadPoolExecutor(1) as ex:
            first = ex.submit(_obs_get, port,
                              f"/debug/profile?ms={OBS_PROFILE_MS}", 120)
            # a second capture while the first holds the profiler
            _health_wait(lambda: "capture_profile" in _obs_get(
                port, "/debug/stacks")[1], "the first capture to start",
                timeout=60, every=0.02)
            code2, body2, _ = _obs_get(port, "/debug/profile?ms=10")
            code, body, res["profile_request_s"] = first.result()
        check(code2 == 409, f"obs: a concurrent /debug/profile answered "
                            f"{code2} {body2}, not 409")
        check(code == 200, f"obs: /debug/profile answered {code} {body}")
        info = json.loads(body)
        names = _obs_trace_names(info["trace"])
        res["profile"] = {**info, "trace_bytes": os.path.getsize(
            info["trace"]), "events": len(names)}
        want = {"program": f"dt.train.step[{HEALTH_B}x{HEALTH_T}]",
                "flash_fwd": "flash_fwd", "flash_bwd_dkv": "flash_bwd_dkv",
                "flash_bwd_dq": "flash_bwd_dq", "ce_fwd": "ce_fwd",
                "ce_bwd": "ce_dz"}
        found = {k: sorted(n for n in names if n and v in n)[:3]
                 for k, v in want.items()}
        res["profile"]["names"] = found
        missing = [k for k, v in found.items() if not v]
        check(want["program"] in names and not missing,
              f"obs: the /debug/profile trace lacks {missing} (program "
              f"in it: {want['program'] in names})")
        role.stop()
        out = role.join()
    finally:
        role.kill()
    recs = _health_jsonl(jl)
    step = _obs_prog(recs, "train.step")
    rl = [r for r in recs if "devprof" in r][-1]["devprof"]["roofline"]
    analytic = _obs_analytic_flops(cfg, out["first_batch"])
    rel = abs(step["flops"] - analytic["total"]) / analytic["total"]
    res.update(steps=out["steps"], train_step=step, roofline=rl,
               analytic_flops=analytic, flops_rel_err=rel,
               first_batch=out["first_batch"],
               first_step_wall_ms=out["step_wall_ms"][0])
    log("obs (a): train.step", json.dumps(step), "analytic",
        json.dumps(analytic), "rel", rel)
    check(rl["known"], f"obs: the roofline does not know the card: {rl}")
    check(step["flops"] and step["flops"] > 0,
          f"obs: train.step counted no FLOPs: {step}")
    check(rel <= OBS_FLOPS_TOL, f"obs: train.step's {step['flops']} FLOPs "
          f"are {rel:.4f} off the analytic {analytic['total']}")
    frac = step.get("achieved_flops_frac")
    check(frac is not None and 0 < frac <= 1.05,
          f"obs: train.step's achieved_flops_frac {frac} not in (0, 1.05]")
    beat = LocalFSTransport(os.path.join(work, "artifacts")).fetch_delta_meta(
        heartbeat_id("miner", "hotkey_1"))
    anat = {k: v for k, v in (beat or {}).items() if k.startswith("anat.")}
    res["beat_anatomy"] = anat
    check({"anat.step_ms", "anat.device_ms", "anat.host_ms"} <= set(anat),
          f"obs: the miner's last beat carries no step anatomy: {beat}")
    L, n = cfg.n_layer, out["steps"]
    want = {"flash_attention_fwd": L * n, "flash_attention_bwd_dkv": L * n,
            "flash_attention_bwd_dq": L * n, "fused_ce_fwd": n,
            "fused_ce_bwd_dh": n, "fused_ce_bwd_dw": n, "dequant_scatter": 0}
    res["launches"] = out["launches"]
    check(n >= 10 and out["launches"] == want,
          f"obs: the miner's launches {out['launches']} != {want}")
    return res


def _obs_server(tmp: str, tree) -> dict:
    """31(b): the server CLI with ``--obs-port`` and ``--metrics-path``:
    phase 21's prompts as 8 greedy requests, /metrics scraped while it
    serves."""
    import threading
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    L = gpt2.PRESETS["gpt2-124m"].n_layer
    prompts, _ = _serve6_traffic(gpt2.PRESETS["gpt2-124m"].vocab_size)
    bodies = [{"tokens": p, "max_new_tokens": 32} for p in prompts]
    work = os.path.join(tmp, "b")
    LocalFSTransport(os.path.join(work, "artifacts")).publish_base(tree)
    port, obs_port = _free_port(), _free_port()
    jl = os.path.join(tmp, "b.jsonl")
    last: dict = {}
    stop = threading.Event()

    def scrape():
        while not stop.is_set():
            try:
                code, body, dt = _obs_get(obs_port, "/metrics", 10)
                if code == 200 and "dt_serve_ttft_ms{" in body:
                    last.update(body=body, s=dt)
            except OSError:
                pass
            time.sleep(0.2)

    th = threading.Thread(target=scrape, daemon=True)
    th.start()
    try:
        run = _server_cli(["--work-dir", work, *DEFAULT_FLAGS,
                           "--model", HEALTH_MODEL,
                           "--serve-port", str(port), "--swap-poll", "1",
                           "--max-steps", "100000", "--obs-port",
                           str(obs_port), "--metrics-path", jl],
                          port, bodies)
    finally:
        stop.set()
        th.join(30)
    eng = run["engine"]
    body = last.get("body", "")
    check(all(out.get("status") == "done" for _, out in run["results"]),
          "obs: a served request did not finish")
    check('dt_serve_ttft_ms{q="0.5"}' in body
          and 'dt_prog_exec_ms{prog="serve.decode",' in body,
          "obs: the server's /metrics lacks the ttft family or "
          "serve.decode's exec series")
    want = {"paged_decode_attention": L * eng.decode_dispatches,
            "paged_window_attention": L * eng.suffix_prefills,
            "flash_attention_fwd": L * eng.full_prefills}
    got = {k: run["launches"][k] for k in want}
    check(eng.decode_dispatches > 0 and got == want
          and not any(v for k, v in run["launches"].items()
                      if k not in want),
          f"obs: the server's launches {run['launches']} != {want}")
    decode = _obs_prog(_health_jsonl(jl), "serve.decode")
    return {"launches": run["launches"], "want": want,
            "decode_dispatches": eng.decode_dispatches,
            "serve_decode": decode, "scrape_s": last.get("s"),
            "serve_lines": [ln for ln in body.splitlines()
                            if ln.startswith(("dt_serve_ttft_ms{",
                                              'dt_prog_exec_ms{prog="serve.'))],
            "boot_s": run["boot_s"], "wall_s": run["wall_s"]}


def _obs_chaos_argv(work: str, hotkey: str, jl: str, extra: list) -> list:
    return [*DEFAULT_FLAGS, "--backend", "local", "--work-dir", work,
            "--model", HEALTH_MODEL, "--hotkey", hotkey,
            "--no-base-wire-v2", "--flight-events", "0",
            "--batch-size", str(HEALTH_B), *HEALTH_EVAL,
            "--chaos-spec", json.dumps(OBS_CHAOS_SPEC),
            "--metrics-path", jl, *extra]


def _obs_chaos_miners(tmp: str, cfg) -> list:
    """31(c), first half: the two chaos miners (dense pushes, hotkey_2
    partitioned), started as processes."""
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    work = os.path.join(tmp, "c")
    LocalFSTransport(os.path.join(work, "artifacts")).publish_base(
        models.init_params_numpy(cfg, SEED))
    return [_HealthRole(tmp, f"chaos_{hk}", "miner", _obs_chaos_argv(
        work, hk, os.path.join(tmp, f"chaos_{hk}.jsonl"),
        ["--fused-loss", "--seq-len", str(HEALTH_T), "--max-steps", "3",
         "--checkpoint-interval", "0", "--no-anomaly-trace",
         "--send-interval", "1e9", "--check-update-interval", "1e9",
         "--self-eval-interval", "0"])) for hk in ("hotkey_1", "hotkey_2")]


def _obs_chaos_round(tmp: str, miners: list, cfg) -> dict:
    """31(c), second half: the miners joined, then one validator round
    (one ingest worker) with the same spec; verdicts, positive scores and
    every process's chaos counters against OBS_CHAOS_ROUND."""
    runs = {m.name.removeprefix("chaos_"): m.join() for m in miners}
    work = os.path.join(tmp, "c")
    jl = os.path.join(tmp, "chaos_validator.jsonl")
    runs["validator"] = _HealthRole(tmp, "chaos_validator", "validator",
                                    _obs_chaos_argv(work, "hotkey_91", jl, [
                                        "--rounds", "1",
                                        "--ingest-workers", "1"])).join()
    (rnd,) = [r for r in _health_jsonl(jl) if "round_scores" in r]
    scores = rnd["round_scores"]
    got = {"verdicts": {hk: scores[hk]["reason"]
                        for hk in OBS_CHAOS_ROUND["verdicts"]},
           "positive": sorted(hk for hk, s in scores.items()
                              if s["score"] > 0),
           "chaos": {}}
    for name in OBS_CHAOS_ROUND["chaos"]:
        regs = [r for r in _health_jsonl(os.path.join(
            tmp, f"chaos_{name}.jsonl")) if "obs_registry" in r]
        got["chaos"][name] = {k: v for k, v in (regs[-1] if regs else {})
                              .items() if k.startswith("chaos.")}
    check(got == OBS_CHAOS_ROUND, f"obs: the chaos round on the card "
          f"{got} != the CPU's {OBS_CHAOS_ROUND}")
    L = cfg.n_layer
    evals = runs["validator"]["candidate_batches"]
    check(runs["validator"]["launches"]["flash_attention_fwd"] == L * evals
          and evals > 0, f"obs: the chaos validator's launches "
          f"{runs['validator']['launches']} for {evals} candidate-batches")
    for hk in ("hotkey_1", "hotkey_2"):
        n = runs[hk]["steps"]
        check(n == 3 and runs[hk]["launches"]["flash_attention_fwd"] == L * n,
              f"obs: chaos miner {hk}: {n} steps, {runs[hk]['launches']}")
    return {**got, "scores": {hk: scores[hk]["score"]
                              for hk in OBS_CHAOS_ROUND["verdicts"]},
            "launches": {k: r["launches"] for k, r in runs.items()},
            "wall_s": {k: r["wall_s"] for k, r in runs.items()}}


def _obs_ab(tmp: str, cfg) -> dict:
    """31(d): one back-to-back pair of 30-step miners with
    ``--metrics-path``, without and with ``--no-devprof``: each one's
    step p50 (``miner.step_ms``) and first step's host wall."""
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    work = os.path.join(tmp, "d")
    LocalFSTransport(os.path.join(work, "artifacts")).publish_base(
        models.init_params_numpy(cfg, SEED))
    out = {}
    for i, (side, extra) in enumerate((("devprof", []),
                                       ("no_devprof", ["--no-devprof"]))):
        jl = os.path.join(tmp, f"d_{side}.jsonl")
        r = _HealthRole(tmp, f"ab_{side}", "miner", _health_argv(
            work, f"hotkey_{70 + i}", _health_miner(OBS_AB_STEPS) + extra,
            metrics=jl, beats=False)).join()
        recs = _health_jsonl(jl)
        reg = [x for x in recs if x.get("obs_registry") == "miner"][-1]
        check((side == "devprof") == any("devprof" in x for x in recs),
              f"obs: {side} miner's JSONL and its devprof records")
        out[side] = {"step_ms_p50": reg["miner.step_ms.p50"],
                     "first_step_wall_ms": r["step_wall_ms"][0],
                     "steps": r["steps"], "s": r["s"],
                     "wall_s": r["wall_s"]}
    out["p50_ratio"] = (out["devprof"]["step_ms_p50"]
                        / out["no_devprof"]["step_ms_p50"])
    out["first_step_extra_ms"] = (out["devprof"]["first_step_wall_ms"]
                                  - out["no_devprof"]["first_step_wall_ms"])
    return out


def _obs_kernels(tok) -> dict:
    """The kernels phase 31 runs, against their plain versions at its
    shapes: flash forward and backward at the miner's [4, 512, 12, 64]
    (bf16, a real packed batch's ids), the fused CE at its 2044 rows
    (bf16, the batch's targets and mask), paged decode at the server's 8
    slots (contexts 515-664) and the window at its 64-row suffix over
    512."""
    import torch
    from distributedtraining_tpu_torch.ops import paged_attention as pa
    batch = _batches(tok, split="train", batch_size=HEALTH_B,
                     seq_len=HEALTH_T, n=1)[0]
    seg = batch["segment_ids"].astype("int32")
    bf = torch.bfloat16
    flash = _flash_check(f"obs_b{HEALTH_B}_t{HEALTH_T}", *_flash_case(
        HEALTH_B, HEALTH_T, 12, 64, seg, bf, SEED + 31))
    ids, mask = batch["input_ids"][:, 1:], batch["loss_mask"][:, 1:]
    h, w, y, g = _ce_inputs(ids.size, 50304, 768, bf, SEED + 31,
                            labels=ids, mask=mask)
    outs = _ce_run(h, w, y, g)
    ce = {k: list(v) for k, v in _ce_check(f"obs_n{ids.size}", outs,
                                           "bfloat16").items()}
    del outs, h, w
    lens = [515, 521, 529, 542, 560, 576, 602, 664]
    args = _decode_case(8, 12, 12, 64, 16, 64, lens, bf, SEED + 31)
    out = pa.paged_decode_attention(*args)
    ref = pa.paged_decode_reference(*args)
    dec = float((out.float() - ref.float()).abs().max())
    check(dec <= 2e-2, f"obs: paged decode vs plain at the server's "
                       f"slots: {dec}")
    wargs = _window_case(1, 64, [512], bf, SEED + 31)
    wout = pa.paged_window_attention(*wargs)
    f32 = [a.float() if a.is_floating_point() else a for a in wargs]
    ratio = _window_bf16_ratio(wout, pa.paged_decode_reference(*f32))
    check(ratio <= 1.0, f"obs: the window vs plain at the suffix: {ratio}")
    torch.cuda.synchronize()
    return {"flash": flash, "ce": ce, "paged_decode_max_abs": dec,
            "window_limit_ratio": ratio}


def phase_obs(ab: bool = True) -> dict:
    """Phase 31 (see the module docstring); without ``ab``, no 31(d)
    (``--devprof-ab`` makes that comparison in full)."""
    import tempfile
    from distributedtraining_tpu_torch import models
    cfg = models.gpt2.PRESETS[HEALTH_MODEL]
    t0 = time.perf_counter()
    # what a process's first cost probe costs on this machine beyond its
    # program (a fresh interpreter, one op under the probe)
    first = subprocess.run(
        [sys.executable, "-c", "import time, torch; from "
         "distributedtraining_tpu_torch.utils import devprof; t = "
         "time.perf_counter()\nwith devprof._probe_mode_class()():\n"
         "    torch.ones(1).add_(1)\nprint(time.perf_counter() - t)"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    check(first.returncode == 0, f"obs: a first probe: {first.stderr}")
    res = {"first_probe_s": float(first.stdout.split()[-1]),
           "kernels": _obs_kernels(_tokenizer())}
    with tempfile.TemporaryDirectory(dir=_lora_work_root()) as tmp:
        t1 = time.perf_counter()
        res["miner"] = _obs_miner(tmp, cfg)
        res["miner"]["s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        miners = _obs_chaos_miners(tmp, cfg)
        try:
            res["server"] = _obs_server(tmp, models.init_params_numpy(
                cfg, SEED))
            res["server"]["s"] = time.perf_counter() - t1
            res["chaos"] = _obs_chaos_round(tmp, miners, cfg)
        finally:
            for m in miners:
                m.kill()
        res["chaos"]["s"] = time.perf_counter() - t1
        if ab:
            t1 = time.perf_counter()
            res["ab"] = _obs_ab(tmp, cfg)
            res["ab"]["s"] = time.perf_counter() - t1
    res["s"] = time.perf_counter() - t0
    return res


def obs_child(out: str) -> int:
    """``--obs-child OUT``: phase 31 in a child process (in the whole
    script after phase 30's, beside the llama chain), without 31(d); its
    result as JSON in OUT."""
    phase_env()
    sys.path.insert(0, ROOT)
    res = phase_obs(ab=False)
    log("obs:", json.dumps(res, default=str)[:20000])
    with open(out, "w") as f:
        json.dump(res, f, default=str)
    return 0


def obs_only() -> int:
    """``--obs``: phase 31 alone after the build; the ``obs`` line, the
    card's line and the result line."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    phase_build()
    res = phase_obs()
    print(json.dumps({"obs": {**res, "card": card}}, default=str),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


DEVPROF_AB_ROUNDS = 12         # --devprof-ab: in-process rounds
DEVPROF_AB_PAIRS = 10          # --devprof-ab: miner CLI pairs


def _paired(on: list, off: list, key: str) -> dict:
    """Relative differences (on - off) / off of ``key``, pair by pair:
    their median, quartiles and range."""
    d = sorted((a[key] - b[key]) / b[key] for a, b in zip(on, off))
    q = statistics.quantiles(d, n=4) if len(d) > 1 else [d[0]] * 3
    return {"median": statistics.median(d), "q1": q[0], "q3": q[2],
            "min": d[0], "max": d[-1], "n": len(d), "diffs": d}


def _devprof_ab_blocks(cfg, rounds: int) -> dict:
    """The in-process half of :func:`devprof_ab`: one ``TrainEngine``
    (``--fused-loss``, B 4 x T 512), blocks of ``OBS_AB_STEPS`` steps
    through its ``train.step`` program with the observatory off and on
    (``devprof.disable`` / ``enable``), the loss read every 5 steps as
    the miner reads it at ``--log-every 5``; one block of each side a
    round, the order swapped each round, after a warm-up block that
    takes the first call (the cost probe, the kernels' first
    launches)."""
    import torch
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.utils import devprof
    tok = _tokenizer()
    batches = _batches(tok, split="train", batch_size=HEALTH_B,
                       seq_len=HEALTH_T, n=OBS_AB_STEPS)
    eng = TrainEngine(gpt2.make_model(cfg)[0], fused_loss=True, device=DEV)
    state = eng.init_state(gpt2.params_from_numpy(
        models.init_params_numpy(cfg, SEED), device=DEV))
    out: dict = {"off": [], "on": [], "order": []}

    def block(on: bool) -> dict:
        nonlocal state
        (devprof.enable if on else devprof.disable)()
        torch.cuda.synchronize()
        step_ms = []
        t_all = time.perf_counter()
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            state, m = eng.train_step(state, eng.place_batch(batch))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if (i + 1) % 5 == 0:
                float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_all) * 1e3
        return {"step_ms_p50": statistics.median(step_ms),
                "ms_per_step": wall_ms / len(batches)}

    try:
        out["warmup"] = block(True)
        for r in range(rounds):
            for side in (("off", "on") if r % 2 == 0 else ("on", "off")):
                out["order"].append(side)
                out[side].append(block(side == "on"))
        rec = [x for x in devprof.records() if x.prog == "train.step"]
        out["calls_observed"] = rec[0].calls if rec else 0
    finally:
        devprof.reset()
    check(out["calls_observed"] == OBS_AB_STEPS * (rounds + 1),
          f"devprof-ab: train.step observed {out['calls_observed']} times")
    for key in ("ms_per_step", "step_ms_p50"):
        out[f"paired_{key}"] = _paired(out["on"], out["off"], key)
    return out


def _devprof_ab_cli(cfg, pairs: int) -> dict:
    """The process half of :func:`devprof_ab`: phase 31's 30-step miner
    CLI with ``--metrics-path``, without and with ``--no-devprof``,
    alternating (on, off, off, on, ...), one process at a time; each
    run's steps after the first: their p50 and mean host wall (the
    miner reads its loss every 5 steps, so the mean holds the card's
    time)."""
    import tempfile
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    out: dict = {"off": [], "on": [], "order": []}
    with tempfile.TemporaryDirectory(dir=_lora_work_root()) as tmp:
        work = os.path.join(tmp, "w")
        LocalFSTransport(os.path.join(work, "artifacts")).publish_base(
            models.init_params_numpy(cfg, SEED))
        for i, on in enumerate(([True, False, False, True] * pairs)
                               [:2 * pairs]):
            jl = os.path.join(tmp, f"ab{i}.jsonl")
            r = _HealthRole(tmp, f"ab{i}", "miner", _health_argv(
                work, f"hotkey_{60 + i}", _health_miner(OBS_AB_STEPS)
                + ([] if on else ["--no-devprof"]), metrics=jl,
                beats=False)).join()
            recs = _health_jsonl(jl)
            check(on == any("devprof" in x for x in recs),
                  f"devprof-ab: run {i}'s JSONL and its devprof records")
            steps = r["step_wall_ms"][1:]
            out["order"].append("on" if on else "off")
            out["on" if on else "off"].append(
                {"step_ms_p50": statistics.median(steps),
                 "ms_per_step": sum(steps) / len(steps),
                 "first_step_ms": r["step_wall_ms"][0], "s": r["s"],
                 "wall_s": r["wall_s"]})
    for key in ("ms_per_step", "step_ms_p50"):
        out[f"paired_{key}"] = _paired(out["on"], out["off"], key)
    return out


def devprof_ab(argv: list) -> int:
    """``--devprof-ab [ROUNDS [CLI_PAIRS]]``: the device observatory's
    cost on the miner's step at GPT-2-124M (``--fused-loss``, B 4 x T
    512; JAX holds its own below 2%): ROUNDS in-process rounds (default
    12) of one block of 30 steps with devprof off and one with it on,
    then CLI_PAIRS pairs (default 10) of the 30-step miner CLI without
    and with ``--no-devprof``, alternating; for each, the pairs' median
    relative difference and its spread. One ``devprof_ab`` line, the
    card's line. No claim."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    from distributedtraining_tpu_torch import models
    rounds = int(argv[0]) if argv else DEVPROF_AB_ROUNDS
    pairs = int(argv[1]) if len(argv) > 1 else DEVPROF_AB_PAIRS
    check(rounds >= 1 and pairs >= 0,
          f"--devprof-ab: {rounds} rounds, {pairs} CLI pairs")
    phase_build()
    cfg = models.gpt2.PRESETS[HEALTH_MODEL]
    t0 = time.perf_counter()
    res = {"in_process": _devprof_ab_blocks(cfg, rounds)}
    if pairs:
        res["cli"] = _devprof_ab_cli(cfg, pairs)
    res["s"] = time.perf_counter() - t0
    print(json.dumps({"devprof_ab": {**res, "card": card}}), flush=True)
    print(card, flush=True)
    return 0


def _obs_entries(entries: list, obs_res: dict) -> list:
    """The kernels line's entries with phase 31's launches: the scraped
    miner, the server, the chaos processes."""
    srv = obs_res["server"]["launches"]
    chaos = obs_res["chaos"]["launches"]
    for e in entries:
        counter = ("fused_ce_bwd_dh" if e["name"] == "fused_ce_bwd"
                   else e["name"])
        got = {"launches_miner": obs_res["miner"]["launches"].get(counter, 0),
               "launches_server": srv.get(counter, 0),
               **{f"launches_chaos_{k}": v.get(counter, 0)
                  for k, v in chaos.items()}}
        if any(got.values()):
            e["obs"] = got
    return entries


# --convert: Llama-2-7B from a sharded bf16 checkpoint --------------------

def _hf_llama_names(cfg) -> list:
    """``(port key, HF name, transposed)`` of every Llama parameter, in
    HF's order (embeddings, then layer by layer, then the norm and the
    head)."""
    out = [("wte", "model.embed_tokens.weight", False)]
    pairs = (("attn_norm.scale", "input_layernorm.weight", False),
             ("wq.kernel", "self_attn.q_proj.weight", True),
             ("wk.kernel", "self_attn.k_proj.weight", True),
             ("wv.kernel", "self_attn.v_proj.weight", True),
             ("wo.kernel", "self_attn.o_proj.weight", True),
             ("mlp_norm.scale", "post_attention_layernorm.weight", False),
             ("w_gate.kernel", "mlp.gate_proj.weight", True),
             ("w_up.kernel", "mlp.up_proj.weight", True),
             ("w_down.kernel", "mlp.down_proj.weight", True))
    for i in range(cfg.n_layer):
        out += [(f"layer_{i}.{k}", f"model.layers.{i}.{n}", t)
                for k, n, t in pairs]
    return out + [("final_norm.scale", "model.norm.weight", False),
                  ("lm_head", "lm_head.weight", False)]


def _fingerprint(t) -> int:
    """An exact, order-free digest of a bf16 tensor's bits on the card:
    the int64 sum (wrapping) of each element's 16 bits times a
    position-dependent odd weight."""
    import torch
    bits = t.contiguous().view(torch.int16).reshape(-1).to(torch.int64)
    idx = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64)
    w = (idx * 2654435761 + 40503) | 1
    return int(torch.sum((bits + 65536) * w))


def _write_llama_checkpoint(path: str, cfg) -> dict:
    """A bf16 HF-layout checkpoint of ``cfg`` (weights drawn on the card
    from SEED, ``_drawn_state``) in two shards named as HF names them
    (``model-0000N-of-00002.safetensors``) and its index; each tensor
    cast and laid out (``[out, in]``) on the card, fingerprinted there,
    then written a shard at a time. Returns the fingerprints, bytes and
    seconds."""
    import torch
    from distributedtraining_tpu_torch import serialization as ser
    os.makedirs(path)
    t0 = time.perf_counter()
    state = _drawn_state(cfg, SEED + 7)
    draw_s = time.perf_counter() - t0
    names = _hf_llama_names(cfg)
    half = 1 + cfg.n_layer // 2 * 9         # embeddings + half the layers
    shards = (names[:half], names[half:])
    prints, weight_map, write_s, nbytes = {}, {}, 0.0, 0
    for i, part in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        host = {}
        for key, name, transposed in part:
            t = state.pop(key).to(torch.bfloat16)
            if transposed:
                t = t.T.contiguous()
            prints[name] = _fingerprint(t)
            host[name] = t.cpu()
            weight_map[name] = fname
            del t
        _lt_free()
        t0 = time.perf_counter()
        ser.save_file(host, os.path.join(path, fname))
        write_s += time.perf_counter() - t0
        nbytes += sum(v.numel() * 2 for v in host.values())
        del host
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": nbytes},
                   "weight_map": weight_map}, f)
    return {"fingerprints": prints, "tensor_bytes": nbytes,
            "file_bytes": sum(os.path.getsize(os.path.join(path, f))
                              for f in os.listdir(path)),
            "draw_s": draw_s, "write_s": write_s}


def _rss_peak_bytes() -> int:
    """This process's peak resident set (``ru_maxrss``: mapped file
    pages it touched count too)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _io_read_bytes() -> dict:
    """This process's read counters (``/proc/self/io``; pages faulted in
    through an ``mmap`` are in neither)."""
    out = {}
    try:
        with open("/proc/self/io") as f:
            for line in f:
                k, v = line.split(":")
                if k in ("rchar", "read_bytes"):
                    out[k] = int(v)
    except OSError:
        pass
    return out


def convert_miner(ckpt: str, out: str) -> int:
    """``--convert-miner CKPT OUT``: the LoRA miner CLI ``--model
    llama2-7b --lora-rank 8 --init-from CKPT`` in a fresh process (its
    host peak is the conversion's), nothing published: the base on the
    card after the bootstrap is the checkpoint's bf16 values in f32
    (each leaf's bf16 image fingerprinted as the writer did, and exact
    in bf16), the steps' losses finite and falling, launches exact (CE
    dW 0); every flash and CE launch of the steps synchronised and
    checked (``_soak_checked``), each step logged. Its result as JSON in
    OUT."""
    import math
    import torch
    from distributedtraining_tpu_torch import models
    from distributedtraining_tpu_torch.engine.lora_train import (
        LoRAEngine, LoRAMinerLoop)
    from distributedtraining_tpu_torch.models import convert
    from distributedtraining_tpu_torch.neurons import miner as miner_cli
    from distributedtraining_tpu_torch.ops import fused_ce
    from distributedtraining_tpu_torch.ops import flash_attention as fa
    phase_env()
    sys.path.insert(0, ROOT)
    cfg = models.llama.PRESETS[CONVERT_BIG]
    res: dict = {"model": CONVERT_BIG, "steps": CONVERT_BIG_STEPS,
                 "batch": [LORA_B, LORA_T], "rank": LORA_RANK}
    io0 = _io_read_bytes()
    rss0 = _rss_peak_bytes()
    rows: list = []
    undo = []

    def hook(owner, name, wrap):
        real = getattr(owner, name)
        setattr(owner, name, wrap(real))
        undo.append((owner, name, real))

    def timed(real):
        def run(*a, **kw):
            t0 = time.perf_counter()
            tree = real(*a, **kw)
            res["convert_s"] = time.perf_counter() - t0
            res["convert_rss_peak_bytes"] = _rss_peak_bytes()
            io = _io_read_bytes()
            res["convert_io"] = {k: io[k] - io0.get(k, 0) for k in io}
            return tree
        return run

    def boot(real):
        def run(loop, *a, **kw):
            t0 = time.perf_counter()
            out = real(loop, *a, **kw)
            _lora_sync()
            res["bootstrap_s"] = time.perf_counter() - t0
            base = loop.base_params
            exact = bad = 0
            prints = {}
            for key, name, transposed in _hf_llama_names(cfg):
                b = base[key]
                h = b.to(torch.bfloat16)
                exact += int(torch.equal(h.float(), b))
                prints[name] = _fingerprint(h.T if transposed else h)
                bad += int(not bool(torch.isfinite(b).all()))
            res["base"] = {"leaves": len(base), "exact_in_bf16": exact,
                           "non_finite": bad, "fingerprints": prints,
                           "bytes": sum(v.numel() * v.element_size()
                                        for v in base.values())}
            _lt_zero()              # the counts cover the steps alone
            return out
        return run

    def step(real):
        def run(eng, state, base, batch):
            _lora_sync()
            t0 = time.perf_counter()
            out = real(eng, state, base, batch)
            _lora_sync()
            rows.append((float(out[1]["loss"]),
                         (time.perf_counter() - t0) * 1e3))
            log(f"convert 7b step {len(rows)}: loss {rows[-1][0]:.4f}, "
                f"{rows[-1][1]:.1f} ms")
            return out
        return run

    last = ["the step's start"]
    seg = (0, 1 << 30)
    for mod, name, bound in ((fa, "flash_attention_fwd", seg),
                             (fa, "flash_attention_bwd_dkv", seg),
                             (fa, "flash_attention_bwd_dq", seg),
                             (fused_ce, "fused_ce_fwd",
                              (0, cfg.padded_vocab)),
                             (fused_ce, "fused_ce_bwd_dh",
                              (0, cfg.padded_vocab))):
        _soak_checked(mod, name, last, {name: bound})
    hook(convert, "load_params", timed)
    hook(LoRAMinerLoop, "bootstrap", boot)
    hook(LoRAEngine, "train_step", step)
    import tempfile
    with tempfile.TemporaryDirectory() as work:
        argv = [*DEFAULT_FLAGS, "--backend", "local", "--work-dir", work,
                "--model", CONVERT_BIG, "--hotkey", "hotkey_1",
                "--lora-rank", str(LORA_RANK), "--init-from", ckpt,
                "--fused-loss", "--learning-rate", str(LORA_BIG_LR),
                "--max-steps", str(CONVERT_BIG_STEPS), "--batch-size",
                str(LORA_B), "--seq-len", str(LORA_T), "--send-interval",
                "1e9", "--checkpoint-interval", "0", "--no-anomaly-trace",
                "--flight-events", "0", "--no-base-wire-v2", *LORA_EVAL]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = miner_cli.main(argv)
        _lora_sync()
        res["cli_s"] = time.perf_counter() - t0
        launches = _lt_launches()
        pushed = os.path.exists(os.path.join(work, "artifacts", "deltas",
                                             "hotkey_1.msgpack"))
    for owner, name, real in reversed(undo):
        setattr(owner, name, real)
    losses = [r[0] for r in rows]
    L, steps = cfg.n_layer, len(rows)
    check(rc == 0, f"convert 7b miner CLI exited {rc}")
    base = {k: v for k, v in res.get("base", {}).items()
            if k != "fingerprints"}
    check(base and base["exact_in_bf16"] == base["leaves"]
          and not base["non_finite"],
          f"convert 7b: the base is not the checkpoint's bf16 values "
          f"({base})")
    check(steps == CONVERT_BIG_STEPS and pushed,
          f"convert 7b miner: {steps} steps, pushed {pushed}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"convert 7b miner losses {losses}")
    _check_launches("convert 7b miner", launches, {
        "flash_attention_fwd": (2 if cfg.remat else 1) * L * steps,
        "flash_attention_bwd_dkv": L * steps,
        "flash_attention_bwd_dq": L * steps,
        "fused_ce_fwd": steps, "fused_ce_bwd_dh": steps})
    step_ms = [r[1] for r in rows]
    res.update(rc=rc, losses=losses, step_ms=step_ms,
               step_ms_p50=statistics.median(step_ms[1:] or step_ms),
               launches=launches, checked_launches=last[0],
               peak_cuda_mem_bytes=torch.cuda.max_memory_allocated(),
               rss_peak_before_bytes=rss0,
               rss_peak_bytes=_rss_peak_bytes())
    with open(out, "w") as f:
        json.dump(res, f, default=str)
    return 0


def _convert_disk() -> str:
    """A directory on a disk (not tmpfs or ramfs) with room for the 7B
    checkpoint: the temporary directory or the checkout; fails without
    one (no depth cut, no fallback)."""
    import shutil
    import tempfile
    for d in (tempfile.gettempdir(), ROOT):
        if _fs_of(d) not in ("tmpfs", "ramfs") and \
                shutil.disk_usage(d).free >= CONVERT_BIG_DISK_BYTES:
            return d
    check(False, f"--convert: no disk with {CONVERT_BIG_DISK_BYTES} bytes "
                 f"free for the checkpoint")


def convert_only() -> int:
    """``--convert``: ``llama2-7b`` at full width and depth from a
    sharded bf16 checkpoint through the LoRA miner CLI (see the module
    docstring); the kernels line of the five kernels it runs, the
    ``convert`` line, the card's line and the result line."""
    import tempfile
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    from distributedtraining_tpu_torch import models
    build = phase_build()
    cfg = models.llama.PRESETS[CONVERT_BIG]
    res: dict = {"times_s": {}}
    with tempfile.TemporaryDirectory(dir=_convert_disk()) as d:
        ckpt = os.path.join(d, CONVERT_BIG)
        t0 = time.perf_counter()
        written = _write_llama_checkpoint(ckpt, cfg)
        res["times_s"]["write"] = time.perf_counter() - t0
        _lt_free()
        log(f"convert 7b: wrote {written['file_bytes']} bytes in "
            f"{res['times_s']['write']:.1f} s")
        out = os.path.join(d, "miner.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--convert-miner",
             ckpt, out], cwd=ROOT, capture_output=True, text=True,
            timeout=CONVERT_BIG_TIMEOUT_S)
        res["times_s"]["miner"] = time.perf_counter() - t0
        log(proc.stderr[-20000:])
        check(proc.returncode == 0,
              f"convert 7b miner child exited {proc.returncode}")
        with open(out) as f:
            miner = json.load(f)
        got = miner["base"].pop("fingerprints")
        want = written.pop("fingerprints")
        check(got == {k: int(v) for k, v in want.items()},
              "convert 7b: the base on the card differs from the "
              "checkpoint (fingerprints)")
        res.update(checkpoint=written, miner=miner,
                   fingerprints_equal=len(want))
    res["checkpoint_deleted"] = not os.path.exists(ckpt)
    check(res["checkpoint_deleted"], "convert 7b: the checkpoint remains")
    launches = res["miner"]["launches"]
    entries = [{"name": name, "route": "cuda", "source": source,
                "build_s": build["build_s"],
                "launches_convert_7b": launches.get(name, 0)}
               for name, source in (
                   ("flash_attention_fwd", FLASH_SOURCE),
                   ("flash_attention_bwd_dkv", FLASH_SOURCE),
                   ("flash_attention_bwd_dq", FLASH_SOURCE),
                   ("fused_ce_fwd", CE_SOURCE),
                   ("fused_ce_bwd_dh", CE_SOURCE),
                   ("fused_ce_bwd_dw", CE_SOURCE))]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"convert": {**res, "card": card}}, default=str),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _window_entry(serve6: dict, build: dict, s6b: dict) -> dict:
    """The window kernel's line: it replaces no Pallas kernel (the JAX
    package runs this attention in XLA)."""
    win = serve6["window"]
    timed = win["timed"]
    runs = serve6["server"]["runs"]
    return {
        "name": "paged_window_attention", "route": "cuda",
        "source": "distributedtraining_tpu_torch/csrc/paged_attention.cu",
        "replaces": "distributedtraining_tpu/ops/paged_attention.py:282",
        "tpu_kernel": None,
        "replaces_note": "paged_decode_reference with Tq > 1 (XLA, not "
                         "Pallas): the suffix prefill and the verify",
        # the server CLI with the JAX defaults (suffix prefills)
        "launches": runs["default"]["launches"]["paged_window_attention"],
        # with --speculative: suffix prefills and verify windows
        "launches_speculative": runs["speculative"]["launches"][
            "paged_window_attention"],
        # phase 22: the prefill worker's suffix prefills
        "launches_serve6b": s6b["paged_window_attention"],
        "max_abs_err": max(c["max_abs_err"] for c in win["checks"]),
        "max_abs_err_f32": max(c["max_abs_err"] for c in win["checks"]
                               if c["dtype"] == "float32"),
        # bf16: the largest share of the per-element limit (<= 1 holds),
        # against the plain version and against the decomposition's
        "bf16_limit_ratio": max(c["limit_ratio"] for c in win["checks"]
                                if "limit_ratio" in c),
        "bf16_limit_ratio_split": max(c["limit_ratio_split"]
                                      for c in win["checks"]
                                      if "limit_ratio_split" in c),
        **timed["verify_w5"],
        "suffix_w512_ctx900": timed["suffix_w512_ctx900"],
        "suffix_w64_ctx512": timed["suffix_w64_ctx512"],
        "timed_shape": "verify_w5 (8 slots, contexts 8-900) bf16",
        "build_s": build["build_s"]}


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
                   meta: dict, defaults: dict, slice5: dict, s6b: dict,
                   genetic: dict) -> list:
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
            # phase 22: the prefill worker behind the router, and the
            # genetic averager's round
            "launches_serve6b": s6b.get(name, 0),
            "launches_genetic": genetic.get(name, 0),
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


def _with_sp_launches(entries: list, launches: dict) -> list:
    """The kernels line's entries, each flash and CE kernel with its
    launches in phase 25's ``--sp 2`` CLI (rank 0) as
    ``launches_sp``."""
    for e in entries:
        counter = "fused_ce_bwd_dh" if e["name"] == "fused_ce_bwd" \
            else e["name"]
        if counter in launches:
            e["launches_sp"] = launches[counter]
    return entries


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
    t0 = time.perf_counter()
    serve6 = {"window": phase_window(), "sampler": phase_sampler(),
              "server": phase_server(tree)}
    serve6["s"] = time.perf_counter() - t0
    # 27b-e, 28a-b, then 26f at a cut depth, run in children beside
    # phases 22-25 (LlamaCli)
    # and phase 29 in a child of its own beside them
    # the children share the card from here: what this process's
    # allocator keeps cached between phases is memory they cannot use
    # (the llama-train child's push needs ~4 GiB beside its ~42 GiB)
    torch.cuda.empty_cache()
    cli = LlamaCli(layers=LLAMA_CLI_LAYERS_MAIN, train=True, lora=True,
                   convert=True)
    try:
        t0 = time.perf_counter()
        serve6b = phase_serve6b(tree, tok)
        serve6b["s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        par = phase_parallel(tree, tok)
        torch.cuda.empty_cache()
        mesh_roles = phase_mesh_roles(tree, tok)
        torch.cuda.empty_cache()
        sp = phase_sp(tree, tok)
        torch.cuda.empty_cache()
        llama = phase_llama(tok, cli)
    finally:
        cli.close()
    llama_train = {"kernels": phase_llama_train_kernels(tok, build),
                   **cli.train_result}
    lora = cli.lora_result
    convert = cli.convert_result
    health = cli.health_result
    obs_res = cli.obs_result
    s6b = serve6b["cli"]["router_traffic"]["launches"]
    server_runs = serve6["server"]["runs"]
    print(json.dumps({"kernels": _obs_entries(_health_entries(
        _convert_entries(
        _lora_entries(
        _lt_entries(_llama_entries(
        _with_sp_launches([{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "distributedtraining_tpu_torch/csrc/paged_attention.cu",
        "replaces": "distributedtraining_tpu/ops/paged_attention.py:107",
        "tpu_kernel": "distributedtraining_tpu/ops/paged_attention.py:"
                      "_decode_kernel",
        "launches": serve["kernel_launches"],
        # phase 21: the server CLI's runs (target and drafter decodes)
        "launches_server": server_runs["default"]["launches"][
            "paged_decode_attention"],
        "launches_server_speculative": server_runs["speculative"][
            "launches"]["paged_decode_attention"],
        # phase 22: the decode worker behind the router
        "launches_serve6b": s6b["paged_decode_attention"],
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
        _window_entry(serve6, build, s6b),
        *_flash_entries(flash, train, build, val, meta, defaults, slice5,
                        s6b, serve6b["genetic"]["launches"]),
        *_ce_entries(ce, miner, tfused, build, defaults, slice5),
        _sharded_entry(par),
        _scatter_entry(scatter, avg, build, defaults, slice5)],
        sp["world2"]["cli"]["sp2"]["launches"][0]), llama),
        llama_train["kernels"], llama_train), lora), convert), health),
        obs_res)}, default=str), flush=True)
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
    print(json.dumps({"slice5": {**slice5, "card": card}}), flush=True)
    print(json.dumps({"serve6": {**serve6, "card": card}}), flush=True)
    total_s = time.perf_counter() - t_start
    print(json.dumps({"serve6b": {**serve6b, "card": card}}, default=str),
          flush=True)
    print(json.dumps({"parallel": {**par, "card": card,
                                   "total_s": total_s}}), flush=True)
    print(json.dumps({"mesh_roles": {**mesh_roles, "card": card,
                                     "total_s": time.perf_counter()
                                     - t_start}}), flush=True)
    print(json.dumps({"sp": {**sp, "card": card,
                             "total_s": time.perf_counter() - t_start}}),
          flush=True)
    print(json.dumps({"llama": {**llama, "card": card,
                                "total_s": time.perf_counter() - t_start}}),
          flush=True)
    print(json.dumps({"llama_train": {**llama_train, "card": card,
                                      "total_s": time.perf_counter()
                                      - t_start}}, default=str), flush=True)
    print(json.dumps({"lora": {**lora, "card": card,
                               "total_s": time.perf_counter() - t_start}},
                     default=str), flush=True)
    print(json.dumps({"convert": {**convert, "card": card,
                                  "total_s": time.perf_counter() - t_start}},
                     default=str), flush=True)
    print(json.dumps({"health": {**health, "card": card,
                                 "total_s": time.perf_counter() - t_start}},
                     default=str), flush=True)
    print(json.dumps({"obs": {**obs_res, "card": card,
                              "total_s": time.perf_counter() - t_start}},
                     default=str), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# Runs one checkout's main() with its phase_* functions timed; argv[1]
# is the file for the times. Nested phase calls are listed each.
_PHASE_TIMER = r"""
import importlib.util, json, sys, time
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
times = []


def timed(name, fn):
    def run(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            times.append([name, time.perf_counter() - t0])
    return run


for name in dir(mod):
    if name.startswith("phase_") and callable(getattr(mod, name)):
        setattr(mod, name, timed(name, getattr(mod, name)))
try:
    rc = mod.main()
finally:
    with open(sys.argv[1], "w") as f:
        json.dump(times, f)
sys.exit(rc)
"""


def phase_times(out: str, dirs: list) -> int:
    """``--phase-times OUT DIR...`` (see the module docstring). Every
    run must exit 0 and end on the result line."""
    os.makedirs(out, exist_ok=True)
    rcs = []
    for i, d in enumerate(dirs):
        name = os.path.join(out, f"run{i}")
        t0 = time.perf_counter()
        with open(name + ".out", "w") as fo, open(name + ".err", "w") as fe:
            rc = subprocess.call(
                [sys.executable, "-c", _PHASE_TIMER,
                 os.path.abspath(name + ".json")],
                cwd=d, stdout=fo, stderr=fe)
        wall = time.perf_counter() - t0
        with open(name + ".out") as f:
            lines = f.read().splitlines()
        ok = bool(lines) and lines[-1].startswith('{"ok": true')
        times = []
        if os.path.exists(name + ".json"):
            with open(name + ".json") as f:
                times = json.load(f)
        print(json.dumps({"phase_times": {"dir": d, "rc": rc, "ok": ok,
                                          "s": wall, "phases": times}}),
              flush=True)
        rcs.append(rc if ok else rc or 1)
    check(not any(rcs), f"--phase-times: runs exited {rcs}")
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


def window_ab(runs: int) -> int:
    """One side of a window-kernel comparison (``--window-ab N``): after
    the build, N times, the window phase's timings (with the card's
    clocks right after them) and the prefix hits' ttft on phase 21's
    traffic, one JSON line each."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    from distributedtraining_tpu_torch.models import gpt2
    phase_build()
    tree = gpt2.init_params_numpy(gpt2.PRESETS["gpt2-124m"], SEED)
    for i in range(runs):
        timed = _window_timings()
        print(json.dumps({"window_ab": {
            "root": ROOT, "run": i, "timed": timed, "clocks": _smi_clocks(),
            "card": card}}), flush=True)
        print(json.dumps({"window_ab_serve": {
            "root": ROOT, "run": i, **_serve_prefix_hits(tree),
            "card": card}}), flush=True)
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


def tp_ab(dirs: list) -> int:
    """The tp engines' timed bf16 steps (phase 23's) with the package of
    each checkout in ``dirs`` in turn (``--tp-ab DIR...``; for example
    parent, change, change, parent), so that two versions of the mesh
    forward compare inside one call: tp 2 on two gloo ranks sharing the
    card, or on a machine of four or more cards fsdp 2 x tp 2 and tp 4
    over NCCL, one rank a card. Each checkout's ``_build/`` is seeded
    from this one's, whose kernel sources it must share. One ``tp_ab``
    line a run."""
    import shutil
    import tempfile
    import torch
    card = phase_env()
    sys.path.insert(0, ROOT)
    phase_build()
    if torch.cuda.device_count() >= 4:
        spec = {"world": 4, "backend": "nccl",
                "meshes": {"fsdp2xtp2": {"fsdp": 2, "tp": 2},
                           "tp4": {"tp": 4}}}
    else:
        spec = {"world": 2, "backend": "gloo", "meshes": {"tp2": {"tp": 2}}}
    pkg = "distributedtraining_tpu_torch"
    for i, d in enumerate(dirs):
        d = os.path.abspath(d)
        check(_same_files(os.path.join(ROOT, pkg, "csrc"),
                          os.path.join(d, pkg, "csrc")),
              f"--tp-ab: {d} has other kernel sources than {ROOT}")
        if d != ROOT:
            shutil.copytree(os.path.join(ROOT, pkg, "_build"),
                            os.path.join(d, pkg, "_build"),
                            dirs_exist_ok=True)
        with tempfile.TemporaryDirectory() as tmp:
            outs = _par_spawn(spec["world"], spec["backend"],
                              {**spec, "dir": d}, tmp, f"tp-ab {d}",
                              mode="--tp-ab-worker")
        print(json.dumps({"tp_ab": {"run": i, "dir": d, "card": card,
                                    "backend": spec["backend"],
                                    "ranks": outs}}), flush=True)
    print(card, flush=True)
    return 0


def _same_files(a: str, b: str) -> bool:
    """True when the two directories hold the same files, byte for byte."""
    import filecmp
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        return False
    match, _, _ = filecmp.cmpfiles(a, b, names, shallow=False)
    return len(match) == len(names)


def tp_ab_worker(rank: int, port: int, tmp: str) -> int:
    """One rank of ``--tp-ab``: the package imported from the spec's
    checkout, ``_par_engine_step`` on each of the spec's meshes."""
    import torch
    with open(os.path.join(tmp, "spec.json")) as f:
        spec = json.load(f)
    sys.path.insert(0, spec["dir"])
    import distributedtraining_tpu_torch as pkg
    from distributedtraining_tpu_torch.delta import flatten_tree
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.parallel import (Mesh, MeshConfig,
                                                        multihost)
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(f"127.0.0.1:{port}", spec["world"], rank,
                         device=DEV, backend=spec["backend"],
                         timeout_s=PAR_TIMEOUT_S)
    try:
        tree = flatten_tree(gpt2.init_params_numpy(
            gpt2.PRESETS[PAR_MODEL], SEED))
        out = {"rank": rank, "package": os.path.dirname(pkg.__file__)}
        for name, kw in spec["meshes"].items():
            out[name] = _par_engine_step(gpt2.PRESETS[PAR_MODEL], tree,
                                         Mesh(MeshConfig(**kw)), DEV)
    finally:
        multihost.shutdown()
    return _par_worker_done(tmp, rank, out)


def serve6b_only() -> int:
    """Phase 22 alone after the build (``--serve6b``): its JSON line,
    the card's line and the result line."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    from distributedtraining_tpu_torch.models import gpt2
    phase_build()
    tok = _tokenizer()
    tree = gpt2.init_params_numpy(gpt2.PRESETS["gpt2-124m"], SEED)
    t0 = time.perf_counter()
    res = phase_serve6b(tree, tok)
    res["s"] = time.perf_counter() - t0
    print(json.dumps({"serve6b": {**res, "card": card}}, default=str),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def parallel_only() -> int:
    """Phase 23 alone after the build (``--parallel``): the sharded CE's
    kernels line, the ``parallel`` line, the card's line and the result
    line."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    from distributedtraining_tpu_torch.models import gpt2
    phase_build()
    tok = _tokenizer()
    tree = gpt2.init_params_numpy(gpt2.PRESETS["gpt2-124m"], SEED)
    par = phase_parallel(tree, tok)
    print(json.dumps({"kernels": [_sharded_entry(par)]}), flush=True)
    print(json.dumps({"parallel": {**par, "card": card}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def mesh_roles_only() -> int:
    """Phase 24 alone after the build (``--mesh-roles``): the
    ``mesh_roles`` line, the card's line and the result line."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    from distributedtraining_tpu_torch.models import gpt2
    phase_build()
    tok = _tokenizer()
    tree = gpt2.init_params_numpy(gpt2.PRESETS["gpt2-124m"], SEED)
    res = phase_mesh_roles(tree, tok)
    print(json.dumps({"mesh_roles": {**res, "card": card}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def parallel_cards() -> int:
    """Phase 23's world over NCCL on every card of the machine
    (``--parallel-cards``, two or more): world 1 on card 0 for its
    checks and the f32 reference, then one rank a card. The
    ``parallel_cards`` line, the card's line and the result line."""
    card = phase_env()
    sys.path.insert(0, ROOT)
    import torch
    from distributedtraining_tpu_torch.delta import flatten_tree
    from distributedtraining_tpu_torch.models import gpt2
    n = torch.cuda.device_count()
    check(n >= 2, f"--parallel-cards needs two or more cards, found {n}")
    phase_build()
    tok = _tokenizer()
    tree = gpt2.init_params_numpy(gpt2.PRESETS["gpt2-124m"], SEED)
    t0 = time.perf_counter()
    w1 = _par_world1(DEV, flatten_tree(tree))
    torch.cuda.empty_cache()
    res = {"world1": w1,
           f"world{n}": _par_run_world(n, "nccl", tree, tok,
                                       w1["f32_losses"])}
    torch.cuda.empty_cache()
    res["mesh_roles"] = phase_mesh_roles(tree, tok, n=n, backend="nccl")
    res["s"] = time.perf_counter() - t0
    print(json.dumps({"parallel_cards": {**res, "card": card}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": n}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--parallel-cards"]:
            sys.exit(parallel_cards())
        if sys.argv[1:2] == ["--phase-times"]:
            sys.exit(phase_times(sys.argv[2], sys.argv[3:]))
        if sys.argv[1:2] == ["--parallel-worker"]:
            sys.exit(parallel_worker(int(sys.argv[2]), int(sys.argv[3]),
                                     sys.argv[4]))
        if sys.argv[1:2] == ["--parallel"]:
            sys.exit(parallel_only())
        if sys.argv[1:2] == ["--sp"]:
            sys.exit(sp_only())
        if sys.argv[1:2] == ["--llama"]:
            sys.exit(llama_only())
        if sys.argv[1:2] == ["--llama-cli"]:
            sys.exit(llama_cli_child(sys.argv[2], *map(int, sys.argv[3:4])))
        if sys.argv[1:2] == ["--llama-train"]:
            sys.exit(llama_train_only())
        if sys.argv[1:2] == ["--llama-train-child"]:
            sys.exit(llama_train_child(sys.argv[2]))
        if sys.argv[1:2] == ["--llama-train-worker"]:
            sys.exit(llama_train_worker(int(sys.argv[2]), int(sys.argv[3]),
                                        sys.argv[4]))
        if sys.argv[1:2] == ["--lora"]:
            sys.exit(lora_only())
        if sys.argv[1:2] == ["--lora-soak"]:
            sys.exit(lora_soak(sys.argv[2:]))
        if sys.argv[1:2] == ["--lora-child"]:
            sys.exit(lora_child(sys.argv[2]))
        if sys.argv[1:2] == ["--convert"]:
            sys.exit(convert_only())
        if sys.argv[1:2] == ["--convert-child"]:
            sys.exit(convert_child(sys.argv[2]))
        if sys.argv[1:2] == ["--health"]:
            sys.exit(health_only())
        if sys.argv[1:2] == ["--health-child"]:
            sys.exit(health_child(sys.argv[2]))
        if sys.argv[1:2] == ["--obs"]:
            sys.exit(obs_only())
        if sys.argv[1:2] == ["--obs-child"]:
            sys.exit(obs_child(sys.argv[2]))
        if sys.argv[1:2] == ["--health-role"]:
            sys.exit(health_role(sys.argv[2], sys.argv[3]))
        if sys.argv[1:2] == ["--beat-ab"]:
            sys.exit(beat_ab(sys.argv[2:]))
        if sys.argv[1:2] == ["--devprof-ab"]:
            sys.exit(devprof_ab(sys.argv[2:]))
        if sys.argv[1:2] == ["--convert-miner"]:
            sys.exit(convert_miner(sys.argv[2], sys.argv[3]))
        if sys.argv[1:2] == ["--lora-worker"]:
            sys.exit(lora_worker(int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4]))
        if sys.argv[1:2] == ["--sp-worker"]:
            sys.exit(sp_worker(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4]))
        if sys.argv[1:2] == ["--tp-ab"]:
            sys.exit(tp_ab(sys.argv[2:]))
        if sys.argv[1:2] == ["--tp-ab-worker"]:
            sys.exit(tp_ab_worker(int(sys.argv[2]), int(sys.argv[3]),
                                  sys.argv[4]))
        if sys.argv[1:2] == ["--mesh-roles"]:
            sys.exit(mesh_roles_only())
        if sys.argv[1:2] in (["--mesh-roles-worker"], ["--mesh-roles-cli"]):
            sys.exit((mesh_roles_worker if sys.argv[1].endswith("worker")
                      else mesh_roles_cli)(int(sys.argv[2]),
                                           int(sys.argv[3]), sys.argv[4]))
        if sys.argv[1:2] == ["--serve6b"]:
            sys.exit(serve6b_only())
        if sys.argv[1:2] == ["--decode-ab"]:
            sys.exit(decode_ab(int(sys.argv[2])))
        if sys.argv[1:2] == ["--flash-ab"]:
            sys.exit(flash_ab(int(sys.argv[2])))
        if sys.argv[1:2] == ["--window-ab"]:
            sys.exit(window_ab(int(sys.argv[2])))
        sys.exit(main())
    except SmokeFailure as e:
        log(f"chip_smoke: FAIL: {e}")
        sys.exit(1)
    except Exception:
        log("chip_smoke: FAIL with an exception:")
        traceback.print_exc()
        sys.exit(1)
