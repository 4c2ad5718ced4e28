#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                  # needs one CUDA device and nvcc
    python3 chip_smoke.py --kernels-only   # phases 1, 2 and the model
                                           # kernels' timings (the SSD's
                                           # too); no result

Drives the port's paths on the CUDA device — the capacity sweep of
llava15-7b at its published widths through ``SweepEngine.sweep(grid,
engine="torch")``, the same sweep over the five other-family archs
(MoE, MLA, hybrid, enc-dec) with the expert and context mesh axes, the planner's search queries
(``planner.plan_min_chips`` / ``plan_frontier`` / ``plan_max_concurrency``
/ ``plan_replicas``) on the torch engine, the calibration pipeline
(``repro_torch.calibrate``) and the sweeps and searches under its fitted
profiles, the serving fleet's request mixes and speculative drafts,
llava15-7b and mamba2-1.3b
serving (prefill + greedy decode) at their published widths and depths
through ``repro_torch.serve.generate``, llava15-7b training steps at the
paper's fig2b setting through ``repro_torch.train``, seamless-m4t-large-v2
(the encoder-decoder) serving and training, arctic-480b (the MoE) serving
at its published width with its depth cut to 2 layers, mamba2-1.3b
training at full size, the MLA family at full size (deepseek-v2-lite-16b
serving, minicpm3-4b serving and training), the hybrid zamba2-2.7b
serving and training at full size, the memory autopilot
(``repro_torch.autopilot``: its drift scenarios, its reshard search on the
card, and real training steps under ``runtime.ResilientTrainer`` restored
from a ``checkpoint.Checkpointer`` checkpoint), the measurement grid
(``repro_torch.launch.measure``: one real step per cell, the predictor's
error on the card), and the training launcher
(``repro_torch.launch.train``: its report and OoM guard, smollm-360m
trained at published width through it, the sharding helpers and ZeRO
step on a 1 x 1 ``DeviceMesh``) — and holds every hand-written kernel
against its plain PyTorch version on the card.
Phases (any failure exits non-zero):

1. toolchain + card line, then the kernels' build (set-up time; a C7508
   "setmaxnreg ignored" warning fails it) and the ``ptxas`` line:
   registers, spills and stack of the bf16 tensor-core flash and SSD
   kernels from ``ptxas -v``; the ``wgmma_build`` line: every wgmma flash
   instance built without a spill and its plan in ``csrc/wgmma_plan.cuh``
   equal to ``flash_attention.wgmma_plan``, both SSD kernels at every
   head width built without a spill or a wgmma serialisation note and
   ``ssd_wgmma_plan`` equal to ``SSD.wgmma_smem`` (else the run fails), and
   ptxas's performance notes on them; the ``sf_build`` line: the
   shard-factor kernel's shape (threads, cells a thread, blocks an SM,
   tile) as csrc reports it, equal to the wrapper's, and its ptxas line
   (a spill fails the run);
2. ``kernels_check``: ``shard_factor`` on randomized step programs, one
   request per launch and packed builds of up to 400 requests per launch
   (broadcast operands, dims past 2^31 and 2^32 — the kernel's 64-bit
   path — beside 32-bit requests in one build, one-cell tiles, the
   kernel's limits; bit-equal on a second launch; requests past the
   limits, a negative dim, a size of 0, a dim past 2^62 and malformed
   buffers refused), and ``segmented_cummax`` on random delta stacks,
   kernel == plain version, exact int64 equality (tolerance 0);
   ``flash_fwd`` and ``rmsnorm_fwd`` on the reference's kernel-test cases
   and at the serving and the training paths' shapes, in fp32
   (tolerance 2e-5; the plain version's matmuls in full fp32,
   ``allow_tf32`` off) and bf16 (tolerance 2e-2), on ``out`` and ``lse``;
   the flash kernels also at the MLA and hybrid head-dim pairs (192, 128),
   (96, 64) and (80, 80) (causal and not, ragged S, a q-offset
   continuation, H = Hkv and GQA) and at deepseek-v2-lite-16b's,
   minicpm3-4b's and zamba2-2.7b's 4 x 2,048 shapes, the RMSNorm at their
   widths (256, 512, 768, 2,560, and zamba2's gated 5,120);
   ``flash_bwd`` (the dq and the dk/dv kernels) on the same cases, the
   training path's shapes and the reduced configs' head dim 16, fp32
   within 5e-4 and bf16 within 2e-2 of each
   gradient's scale, and ``rmsnorm_bwd`` (dx and dscale, 1e-4 / 2e-2),
   each (the forward too) also bit-equal on a second launch, and every
   wrapper refusing what its kernel does not take (float16, a head dim
   above 256); ``ssd_scan`` (fp32: the FMA
   kernel; bf16: the wgmma state pass and chunk scan) on the reference's
   three SSD
   cases, a prompt shorter than the chunk, the mamba2 prefill's full-width
   shape (4, 2,000, 64, 64, 128, 256) and its batch-1 twin, zamba2-2.7b's
   prefill shape (4, 2,048, 80, 64, 64, 256), a state
   width the bf16 kernels pad (N 20, P 128): y and the final state within
   1e-4 in fp32, bf16 y within 2e-2 and the state within 1e-4 of their
   scales, bit-equal on a second launch and on strided views; float16, a
   chunk past shared memory (fp32 and bf16), P above 256 and N above 512
   refused; every
   error also per shape; the same checks, each in the same loop, at
   the shapes the widened kernels take — flash forward and backward at
   the pairs no instance is compiled for, run zero-padded on
   ``FL.instance_for``'s (the reduced MLA archs' (24, 16), (20, 12),
   (112, 112), (256, 128)) and at the (256, 256) instance, 4 x 2,048
   tokens with GQA 2, causal and not; the inputs the wrappers once
   refused, now copied or padded for the kernels (a head-dim slice,
   transposed views, bf16 views off the 16-byte grid, H or B above
   65,535); the RMSNorm backward at D 16,384, past the shared-memory
   partial row; ``SSD.kernel_plan``'s shapes at 4 x 2,048 tokens (P 80 as
   two slabs, P 256 as two slabs of one launch, N 256 at P 64, N 512
   walked in two pieces in fp32 and whole in bf16), the fp32 kernel at (4, 2,048, 64, 64, 256, 256)
   under the reference test's dt against the float64 recurrence (within
   max(1e-4, 2 x the plain version's distance)), and the SSD inputs once
   refused (a head-dim slice, N 14, a strided head dim, bf16 operands off
   the copies' grid, batch 70,000);
3. ``sweep_large``: the 124,416-cell llava15-7b grid, legacy and liveness
   assembly, device engine == host columnar path column for column; one
   ``shard_factor`` launch per stage table build (``table_builds``);
4. ``sweep_pipe``: the same grid with a ``pipe`` mesh axis, both schedules
   and three microbatch counts (1,959,552 cells), liveness assembly;
4b. ``sweep_moe_epcp``: the two MoE archs (arctic-480b, and
   deepseek-v2-lite-16b with its MLA attention) at their published widths
   over every legal expert x context x model x data split of 64/128/256
   chips (299 meshes, 1,377,792 cells), liveness assembly: the checks of
   phase 3, the fit count and the int64 sum of ``peak_bytes`` equal to the
   reference's, and among the six cells held to ``planner.check`` one with
   ``expert > 1`` and one with ``context > 1``;
4c. ``sweep_new_archs``: minicpm3-4b (MLA), seamless-m4t-large-v2 (the
   speech-text encoder-decoder) and zamba2-2.7b (the hybrid) over data x
   model x context meshes (78 meshes, 539,136 cells), legacy assembly, the
   same checks;
4d. ``search``: ``plan_min_chips`` of deepseek-v2-lite-16b and
   arctic-480b with the expert and context axes (pruned on the card, also
   with the oracle on), ``plan_frontier`` of seamless-m4t-large-v2,
   ``plan_max_concurrency`` of zamba2-2.7b at 524,288 and minicpm3-4b at
   32,768 tokens (host probes; their exhaustive twin, every concurrency up
   to the cap, swept on the card and on the host), ``plan_replicas`` and
   ``adam_state_bytes``: each answer equal to the exhaustive host search
   and to the reference's; one ``shard_factor`` launch per table build
   that asks for a denominator;
4e. ``calibrate`` (host): a ``CalibrationProfile`` fitted by
   ``calibrate.fit_profile`` on the bundled measurement fixture under each
   assembly, and a ``ResidualModel`` over it (``fit_residual``): their
   hashes equal to the reference's, the MAPE table by family improved in
   every family; no kernel runs;
4f. ``sweep_calibrated_legacy``: the 124,416-cell grid under the fitted
   legacy profile (v5e, v6e and h100: three chip offsets), and
   ``sweep_calibrated_pipe``: the 1,959,552-cell pipe grid under the
   fitted liveness profile — the checks of phase 3, the fit count and the
   int64 sum of ``peak_bytes`` equal to the reference's, one cell of each
   chip among the six held to ``planner.check(profile=...)``; each then
   again on the same (warm) engine under the goldens' profile, which must
   build its own tables and give the reference's answer;
4g. ``sweep_fleet_legacy`` / ``_liveness``: llava15-7b decode over 22
   meshes x 3 chips x 8 batches x 4 contexts x 72 serving specs (block
   sizes 0 / 16, utilizations 1 / 0.9, hit rates 0 / 0.5, the mixes
   ``0.25:512x1,2048x3``, ``0.5`` and none, drafts none / smollm-360m /
   llama3.2-3b): 152,064 cells, the checks of phase 3 with each checked
   cell's pool / draft / hit bytes, and the sums of those columns equal
   to the reference's;
4h. ``search`` under calibration and mixes: ``plan_min_chips`` of
   arctic-480b under the fitted legacy profile (the floor off: every
   count up to the answer swept) and ``plan_max_concurrency`` of
   llama3.2-3b under a request mix and a draft (its exhaustive twin to
   4,096 sequences on the card and on the host), each equal to the
   reference's;
5. ``serve_llava15_7b``: the 7B VLM with random weights from a seeded
   generator on the card, 4 requests of one 336x336 image (576 patch
   tokens) + 512 text tokens, 32 greedy new tokens: prefill ms, decode ms
   per step, tokens/s, kernel launches per phase, the allocator's peak
   bytes of prefill and of the decode loop beside the port's own
   ``core.predictor`` prediction for the same request; the kernel path's
   prefill logits against the same prefill through the plain versions
   (the gate), both against the plain prefill of the weights cast to
   fp32 (a reading), and the reduced config on the card against the CPU;
5b. ``serve_mamba2_1_3b``: mamba2-1.3b at full width and all 48 layers
   with random weights from a seeded generator on the card, 4 requests
   of 2,000 prompt tokens, 32 greedy new tokens: the same readings as
   serving llava15-7b (launches gated exactly: SSD 48 per prefill and
   none in decode, RMSNorm 97 per prefill and per decode step; the
   predictor's numbers from ``planner.check``); its prefill through the
   kernels against the plain versions in bf16 and with the weights cast
   to fp32, logits and final states (gated in fp32 at ``MAMBA_FP32_TOL``,
   and in bf16 the kernel path no further from the fp32 plain path than
   ``MAMBA_BF16_RATIO`` times the bf16 plain path);
6. ``train_llava15_7b_stage1`` (full width and depth, LLaVA stage 1) and
   ``train_llava15_7b_stage2_8l`` (full width, the LM cut to 8 blocks,
   stage 2): 8 samples x (576 image + 1,472 text) tokens, AdamW, remat
   "block", 3 steps each: ms and loss per step, launches per step against
   the reference's program, the allocator's peak beside the byte model's
   prediction, trainable leaves moved and frozen leaves bit-equal, one
   step under the profiler; the loss and every trainable leaf's gradient
   through the fp32 kernels against the fp32 plain versions (within
   ``FP32_GRAD_TOL`` of each leaf's scale), and the bf16 paths' spread
   from them as a reading (stage 1's again on a line of its own); for
   stage 2 also the planner's
   full-depth verdict on an H100 and the reduced config on the card
   against the CPU; then one stage-2 step each of Adafactor and 8-bit
   Adam, their optimizer state's bytes gated to equal the byte model's
   ``opt_bytes_for`` per leaf;
5c. ``serve_seamless_m4t_large_v2``: the speech-text encoder-decoder at
   full width and depth (24 + 24 layers) with random bf16 weights, 4
   requests of 2,048 frames and 2,048 prompt tokens, 32 greedy tokens:
   the readings of phase 5, launches gated to the reference's program
   (flash 24 encoder + 24 decoder self + 24 cross per prefill, none in
   decode; RMSNorm 146 per prefill, 73 per decode step), the prefill's
   kernel path against the plain path (2e-2 of scale), the reduced config
   on the card against the CPU;
6c. ``train_seamless_m4t_large_v2``: the same model, FULL_TRAIN, AdamW,
   remat "block", 4 x 2,048, 3 steps: the readings and gates of phase 6
   (the loss finite and moving, launches per step the reference's
   program); at the trained weights the fp32 kernel path against the fp32
   plain path is a reading, and the gate holds each fp32 path to the same
   gradients in float64: the kernel path's distance from them (its worst
   leaf) within ``FP32_GRAD_TOL`` or ``FP64_WITNESS_RATIO`` times the
   plain path's;
5d. ``serve_arctic_480b_2l``: the MoE arctic-480b at full published
   width (d_model 7,168, 56 / 8 heads x 128, 128 experts x 4,864 top-2,
   dense residual 4,864, vocab 32,000) with its depth cut to 2 of 35
   layers (one layer is 27.2 GB in bf16; a third does not fit), random
   bf16 weights made on the card one leaf at a time, under
   ``mesh_context({"data": 1, "model": 1})`` (the expert-parallel
   dispatch): 4 prompts of 1,024 tokens, 16 greedy tokens; the readings
   of phase 5 (launches gated: flash 2 per prefill, none in decode,
   RMSNorm 7 per prefill and 5 per decode step; peaks beside the byte
   model of the depth-2 config), the prefill's kernel path against the
   plain path (2e-2 of scale), the share of (token, expert) pairs the
   capacity drops and of tokens whose top-2 set differs between the two
   paths;
6d. ``train_mamba2_1_3b``: mamba2-1.3b at full width and depth, FULL_TRAIN,
   AdamW, remat "block", 4 x 2,048, 3 steps through the chunked SSD in
   plain tensor ops (no SSD kernel: the reference trains through its lax
   twin): the readings and gates of phase 6c (RMSNorm 193 forward and 97
   backward launches per step, no flash, no SSD; the fp32 gradient gate
   at the trained weights with the float64 witness), and the reduced
   config's step on the card against the CPU; no step under the profiler
   (it took 76.6 s of the phase, for no gate; PERF.md § 5 keeps its
   readings);
5e. ``serve_deepseek_v2_lite_16b``: nothing cut (27 layers: one dense
   FFN block of 10,944, then 26 MoE blocks of 64 experts x 1,408 top-6
   and 2 shared experts; d_model 2,048, 16 heads, MLA kv rank 512, head
   dims (192, 128), vocab 102,400; 15.71 B params in bf16 made on the card
   from a seeded generator) under ``mesh_context({"data": 1, "model":
   1})``: 4 prompts of 2,048 tokens, 32 greedy tokens; the readings of
   5d (launches gated to the reference's MLA program: flash 27 per
   prefill, RMSNorm 5 per block + 1, per decode step 3 per block + 1;
   the cache's latent / rope-key leaves per stack; peaks beside the byte
   model; capacity drops and top-6 flips; the prefill's kernel path
   against the plain path, 2e-2 of scale);
5f. ``serve_minicpm3_4b``: nothing cut (62 layers, d_model 2,560, 40
   heads, q rank 768, kv rank 256, head dims (96, 64), vocab 73,448, tied
   embeddings), the same request and readings (RMSNorm 6 per block + 1
   per prefill, 4 per block + 1 per decode step);
6e. ``train_arctic_reduced``: the reduced arctic, the same weights and
   batch on the card and on the CPU under the 1 x 1 mesh, 3 Adafactor
   steps (arctic's own optimizer): the loss of every step and the
   gradients within ``MOE_TOL`` of scale (the reference's own bound for
   MoE configs, whose routing may flip on a rounding), the share of
   flipped routing choices a reading;
6f. ``train_minicpm3_4b``: nothing cut, 4 x 2,048, FULL_TRAIN,
   Adafactor, remat "block", 3 steps: the readings and gates of phase 6c
   (flash forward, dq and dk/dv at (96, 64) through all 62 layers, RMSNorm
   both ways at 768 / 256 / 2,560; launches per step the reference's
   program), the fp32 and float64 comparisons on the first sample (one
   4.07 B-param model's float64 weights and gradients take 65 GB);
6h. ``reduced_mla``: the reduced deepseek-v2-lite-16b (under the 1 x 1
   mesh) and minicpm3-4b, whose attention pair (24, 16) runs zero-padded
   on the (32, 32) instance: each on the card against the CPU, prefill +
   4 decode steps and one Adafactor step under FULL_TRAIN, the logits,
   losses, gradients and params within their family's bound (deepseek
   ``MOE_TOL``, routing flips a reading; minicpm3 2e-2 of scale), flash
   forward, dq and dk/dv launched at (24, 16);
5g. ``serve_zamba2_2_7b``: nothing cut (54 Mamba-2 blocks, 2 shared
   attention blocks invoked 9 times, d_model 2,560, 32 heads x 80, d_state
   64, vocab 32,000; 2.45 B params) with random bf16 weights from a
   seeded generator: 4 prompts of 2,048 tokens, 32 greedy tokens; the
   readings of 5b (launches gated: flash 9, SSD 54, RMSNorm 136 per
   prefill; RMSNorm 127 per decode step; the cache's SSM and K/V leaves;
   peaks beside the byte model), mamba2's gates on the prefill's four
   paths (fp32 kernel vs plain 1e-3 of the logits' and states' scale, the
   bf16 kernel path <= 1.5x the bf16 plain path's distance from fp32), the
   bf16 pair at 2e-2 a reading, the reduced config card against CPU;
6g. ``train_zamba2_2_7b``: nothing cut, 4 x 2,048, FULL_TRAIN, AdamW,
   remat "block", 3 steps: the readings and gates of phase 6c (flash
   forward, dq and dk/dv 9 each at (80, 80); RMSNorm 235 forward — the
   mamba blocks' rerun by the remat, the shared invocations' once — and
   127 backward), the fp32 and float64 comparisons on the first sample,
   the reduced config's step card against CPU (loss and gradients gated;
   the params after AdamW's first step a reading: it moves an element by
   about lr x the sign of its gradient, which a rounding flips where the
   gradient is near zero); no step under the profiler, as 6d;
4i. ``autopilot`` (after 6g): the three drift scenarios, guarded and
   unguarded, at v5e and h100 through the port's defaults, every
   ``ScenarioResult`` field equal to the reference's; the harness cell's
   plan at a drift ratio of 50, its reshard (``plan_min_chips``) on the
   card and on the host, equal to each other and to the reference's
   mesh, both waits printed (C14); ``ResilientTrainer`` over 6
   smollm-360m steps (8 x 2,048, AdamW) with a checkpoint every 2 steps
   and a failure injected at step 5, admission-controlled by an
   ``Autopilot`` on the grid's cell fed the allocator's peak: the
   replayed losses and the final parameters bit-equal to an
   uninterrupted run's, the restored tensors on the card, the watch SAFE;
9. ``launch_train_smollm_360m`` (last): the training launcher
   (``repro_torch.launch.train.main``) as a user runs it — (a)
   ``--check-only`` for llava15-7b on the default (16, 16) mesh: the
   report's verdict, remat, accumulation and peak; (b) arctic-480b on a
   1 x 1 mesh refused by the OoM guard's ``SystemExit`` with nothing
   allocated on the card; (c) smollm-360m at published width and depth on
   train_4k (256 x 4,096 tokens a step, AdamW with its fp32 master, 3
   steps) with the smallest power-of-two accumulation the byte model puts
   under 60 GiB on one h100: losses finite and falling, seconds a step,
   tokens/s, flash and RMSNorm launches equal to the reference's program
   per microbatch x the accumulation x 3, the allocator peak beside the
   byte model's, every batch's SHA-256 equal to the host pipeline's, the
   final checkpoint, the card's busy share over a 1-microbatch step under
   the profiler; (d) an NCCL world of one (a ``FileStore`` in a temporary
   directory) and a 1 x 1 ``DeviceMesh``: smollm-360m's parameters and
   AdamW state placed with ``param_shardings`` / ``opt_shardings``, one
   step at 2 x 2,048 with ``zero_shardings`` bit-equal to the step with no
   mesh (parameters, optimizer state, loss), then a checkpoint restored
   with ``shardings`` onto the mesh, every leaf a ``DTensor`` on its
   placements and bit-equal; the group destroyed at the end;
8. ``measure`` (run right after phase 2, in a process of its own,
   ``--measure-only``, so that its cells meet a caching allocator nothing
   ran on before them): every cell of ``repro_torch.launch.measure.GRID``
   (56 cells of 10 archs at full width and depth) through ``measure_grid``,
   one real step each with the allocator read around it: a ``measure``
   line per dry-run-schema record, each record's prediction equal to the
   host's ``planner.check`` for its cell, the store written to
   ``experiments/measured``, then the ``measure_summary`` line — the
   predictor's MAPE per arch x kind, family, the multimodal training
   cells and all cells, raw under the ``tpu`` and ``cpu`` term sets,
   calibrated on the even cells and held out on the odd ones; the
   records of the 32 counted cells (``measure.counted_cells``: the first
   of each arch x kind x sequence length x policy x remat) also carry the
   ``cost``, ``collectives`` and ``loop_aware`` blocks of one more step of
   their cell counted by a ``core.device_metrics.StepCounter`` once the last
   cell of its state was measured, every record ``step_s`` (CUDA events
   around a warm step with no counter: a train cell's second, a serving
   cell's second run; the summary's ``counted_steps_s`` is the counted
   steps' time), each counted ``measure`` line a
   ``reading`` of dot TFLOP per step, TFLOP/s and its share of the dense
   bf16 peak; gated: every cell's ``memory.total_bytes`` equal to the
   committed store's, time present, FLOPs present exactly on the counted
   cells, no
   collective on one card, and on the first llava15-7b training cell
   (``counter_twin``) a step under the counter with the peak and launches
   of the same step without it;
10. ``surface``: (c) the sweep CLI's ``--dry-run`` estimate for
   the large legacy grid beside the same grid run cold on the card (in
   this process, a reading); then, each a process of its own, all started
   together: (a) ``python -m repro_torch.configs`` equal to the table in
   ``docs/configs.md``; (b) ``--breakdown`` of llava15-7b on
   ``data=4,model=2,pipe=2`` x 4 microbatches and of deepseek-v2-lite-16b
   on an expert / context mesh; (d) the five ``repro_torch.examples`` on
   the card (``predict_memory --validate`` on smollm-360m at 524,288
   positions, ``train_llava_e2e --steps 20`` with its loss finite and
   falling, ``serve_batched`` with tokens in the vocabulary; their times
   are readings taken beside each other);
7. timings: cold / warm wall time, cells/s and the phase split of each
   sweep, and per kernel — at the largest shape its path gave it — the
   median of CUDA-event-timed calls of its wrapper (``ms``), the kernel's
   own device time from a profiler trace (``device_ms``), the plain
   version's time, the roofline bound and the time of the one PyTorch
   call that computes the same function, where there is one (none for
   the SSD scan), with ``share_of_bound`` (bound / kernel alone) and
   ``vs_library`` (kernel alone / library call); the sweep kernels with
   the L2 flushed before each timed launch (their operands fit in it),
   the flash rows also at the MLA and hybrid pairs (operations counted
   at D for the q / k products and at Dv for P v and dv; the SDPA
   backend that ran named; the backward at (192, 128) at deepseek's
   prefill shape), the RMSNorm both ways and the SSD also at
   zamba2-2.7b's shapes; the widened kernels: flash forward, dq and dk/dv
   at the (256, 256) instance (4 x 2,048, 16 heads) and at the padded
   (24, 16) as the reduced MLA archs give it, each with its instance and
   the padded products over the true ones (the bound counts the true
   shape's work, SDPA runs at the true shape), the RMSNorm backward at D
   16,384, the SSD at P 256 (two slabs) and N 512 (one launch); the SSD
   row names its design (``wgmma``), each of its two kernels' time alone
   (``kernel_ms``) and their sum (``device_ms``);
   ``shard_factor`` at the packed shape of the sweeps' largest table
   build and (``other_shapes``) at the searches' first, small, cold one,
   each with its ``host_call_us``, ``wrapper_minus_kernel_us`` and
   ``host_roundtrip_ms`` (upload, launch, read-back), the row with its
   ``design`` (the ``sf_build`` line); each flash row names its design
   (``wgmma``) and its instance's tile, stages, threads, ptxas line and
   shared memory, and the host
   side of a wrapper call: ``wrapper_minus_kernel_us`` (the event time
   less the kernel alone), ``host_call_us`` (the wrapper's own time on
   the host clock until it returns) and, for the dq pass,
   ``encode_us``, the four ``cuTensorMapEncodeTiled`` calls of one
   launch timed apart.

The ``sweep_resident`` line gives the bytes the sweeps leave allocated,
which every later allocator peak includes (none: the sweep engines are
gone and the shape log is kept on the host); each serving and training
line gives ``resident_at_start_bytes``.

Each path is run with the kernels' launch counters set to 0 just before
and read just after; a kernel of the path that was launched no time fails
the run.  The line before the last is the ``nvidia-smi`` name / power-limit
line, the ``{"kernels": [...]}`` line stands before it, and the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
          file=sys.stderr)
    raise SystemExit(2)

import torch.nn.functional as F  # noqa: E402

from repro_torch import autopilot as AP  # noqa: E402
from repro_torch.autopilot import harness as AP_HARNESS  # noqa: E402
from repro_torch.calibrate import fit as CF  # noqa: E402
from repro_torch.calibrate import learned as CL  # noqa: E402
from repro_torch.calibrate import report as CR  # noqa: E402
from repro_torch.calibrate.measurements import MeasurementStore  # noqa: E402
from repro_torch.calibrate.profile import CalibrationProfile  # noqa: E402
from repro_torch.core import batch as B  # noqa: E402
from repro_torch.core import factors as FA  # noqa: E402
from repro_torch.core import planner as PL  # noqa: E402
from repro_torch.core import predictor as PR  # noqa: E402
from repro_torch.core import search as SR  # noqa: E402
from repro_torch.core import sweep as SW  # noqa: E402
from repro_torch.core.spec import (FULL_TRAIN, LLAVA_STAGE1,  # noqa: E402
                                   LLAVA_STAGE2)
from repro_torch.configs import (SHAPES, ShapeConfig,  # noqa: E402
                                 get_config)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FL  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import segmented_cummax as SC  # noqa: E402
from repro_torch.kernels import shard_factor as SF  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402
from repro_torch.calibrate.paths import measured_dir  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.launch import measure as ME  # noqa: E402
from repro_torch.mesh_ctx import mesh_context  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import param as PM  # noqa: E402
from repro_torch.runtime import FaultConfig, ResilientTrainer  # noqa: E402
from repro_torch.serve import serve_step as SV  # noqa: E402
from repro_torch.serve.fleet import parse_mix  # noqa: E402
from repro_torch.serve.pool import ServeSpec  # noqa: E402
from repro_torch.core.parser import parse_model  # noqa: E402
from repro_torch.train import (OptimizerConfig, init_train_state,  # noqa: E402
                               make_train_step, train_state)
from repro_torch.train import optimizer as TO  # noqa: E402

DEV = torch.device("cuda", 0)
SEED = 20260811

# H100 SXM data-sheet peaks the bounds are stated against
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12      # fp32 rate outside the tensor cores; the int64
                           # ALU work of both kernels is slower than that,
                           # so the operations bound errs low (still a bound)
BF16_OPS_PER_S = 989e12    # dense bf16 tensor-core rate (attention's bound)

# the plain versions' float32 matmuls run in full fp32 (no TF32): the
# fp32 kernel checks hold the kernels to 2e-5 against them
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the serving path: llava15-7b, 4 requests of one 336x336 image (576
# patch tokens) + 512 text tokens, 32 greedy new tokens
SERVE_ARCH = "llava15-7b"
SERVE_BATCH, SERVE_TEXT, SERVE_NEW = 4, 512, 32

# the SSM serving path: mamba2-1.3b at full width and depth, 4 requests of
# 2,000 prompt tokens, 32 greedy new tokens
MAMBA_ARCH = "mamba2-1.3b"
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_NEW = 4, 2000, 32
# its full-size prefill, the kernel path against the plain path on the same
# weights and tokens (max |diff| over the compared tensor's scale): read
# 1.9e-5 (logits) / 1.6e-5 (states) in fp32 on an H100, while the two bf16
# paths are 5 % apart and each 6-7 % from fp32 (48 random layers grow
# every bf16 rounding); 1e-3 in fp32 is 50x that reading and a fiftieth
# of the bf16 spread.  The SSD kernel's bf16 output is held by check_ssd at
# this prefill's shape, the RMSNorm's by check_rmsnorm
MAMBA_FP32_TOL = 1e-3
# in bf16 the kernel path's distance from the fp32 plain path, over the
# bf16 plain path's own (logits and states): the bf16 SSD kernels round
# their score operand and the state entering each chunk once more than the
# plain path; the CPU rounding model (tests/test_torch_ssd.py) reads
# 0.84 / 1.00 on the reduced config, 1.5 leaves room for 48 layers
MAMBA_BF16_RATIO = 1.5

# the training path: llava15-7b at the paper's fig2b setting, 8 samples x
# (576 image + 1,472 text) = 8 x 2,048 tokens, AdamW, remat "block", 3
# steps; stage 1 at full depth, stage 2 with the LM cut to 8 of 32 blocks
TRAIN_ARCH = "llava15-7b"
TRAIN_BATCH, TRAIN_TEXT, TRAIN_STEPS = 8, 1472, 3
STAGE2_LAYERS = 8
# the fp32 kernel path's gradients against the fp32 plain path's, each
# trainable leaf's max |diff| over its max |grad|: read 4.7e-6 (stage 1)
# and 7.8e-5 (stage 2, an LM wk) on an H100; the bf16 paths read ~2e-2
# from each other, so 1e-3 catches a kernel that computes in bf16
FP32_GRAD_TOL = 1e-3
# where the two fp32 paths themselves part by more than that (seamless at
# its trained weights: decoder cross-attention wq / wk), the same
# gradients in float64 are the witness: the fp32 kernel path's distance
# from them (its worst leaf, as above) may be at most FP32_GRAD_TOL or
# FP64_WITNESS_RATIO times the fp32 plain path's, whichever is larger.
# The paths' worst leaves, not leaf by leaf: at ~1e-3 of scale one leaf's
# max |diff| under two fp32 summation orders scatters by 2x (PERF.md § 6)
FP64_WITNESS_RATIO = 2.0

# the enc-dec paths: seamless-m4t-large-v2 at full width and depth, 4
# requests of 2,048 frames and 2,048 prompt tokens, 32 greedy new tokens;
# training on 4 x 2,048 (frames and tokens), FULL_TRAIN, AdamW, remat
# "block"
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_NEW = 4, 2048, 32
ENCDEC_TRAIN_BATCH = 4

# the SSM training path: mamba2-1.3b at full width and depth, FULL_TRAIN,
# AdamW, remat "block", 4 x 2,048 tokens, TRAIN_STEPS steps
MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ = 4, 2048

# the MoE serving path: arctic-480b at full published width with its
# depth cut to 2 of 35 layers, 4 prompts of 1,024 tokens, 16 greedy new
# tokens, under a 1 x 1 mesh (the expert-parallel dispatch)
MOE_ARCH = "arctic-480b"
MOE_LAYERS = 2
MOE_BATCH, MOE_PROMPT, MOE_NEW = 4, 1024, 16
MOE_MESH = {"data": 1, "model": 1}
# an MoE config's logits and gradients, card against CPU: a rounding can
# flip a routing choice and move them, so the reference's own MoE bound
# (tests/test_models.py, decode against prefill) holds them; dense
# configs keep 2e-2
MOE_TOL = 8e-2

# the MLA paths, nothing cut: deepseek-v2-lite-16b (MLA + 64 experts top-6,
# 2 shared, a leading dense block) and minicpm3-4b (dense MLA, q rank 768)
# serve 4 prompts of 2,048 tokens and 32 greedy tokens, deepseek under the
# 1 x 1 mesh (the expert-parallel dispatch); minicpm3-4b trains on 4 x
# 2,048 tokens, FULL_TRAIN, Adafactor (AdamW's state does not fit one
# card), remat "block", with its fp32 / float64 comparisons on the first
# MLA_CHECK_BATCH sample (float64 weights and gradients of 4.07 B params
# take 65 GB)
MLA_BATCH, MLA_PROMPT, MLA_NEW = 4, 2048, 32
MLA_TRAIN_BATCH, MLA_CHECK_BATCH = 4, 1

# the hybrid paths, nothing cut: zamba2-2.7b (54 Mamba-2 blocks, 2 shared
# attention blocks invoked 9 times, head dim 80) serves 4 prompts of 2,048
# tokens and 32 greedy tokens, and trains on 4 x 2,048 tokens,
# FULL_TRAIN, AdamW, remat "block", with its fp32 / float64 comparisons on
# the first HYBRID_CHECK_BATCH sample (float64 weights and gradients of
# 2.45 B params take 39 GB)
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_BATCH, HYBRID_PROMPT, HYBRID_NEW = 4, 2048, 32
HYBRID_TRAIN_BATCH, HYBRID_CHECK_BATCH = 4, 1

# phase 4i, the memory autopilot: the reference's outcome of each drift
# scenario, guarded and unguarded (its CLI, ``repro.autopilot``; the same
# at v5e and h100, the budget being normalized to the harness cell):
# (completed, aborted, steps done, steps, OOM steps, mitigations,
# restarts); then the budget, the base cell's prediction and a guarded
# run's final prediction, bytes
AUTOPILOT_WANT = {
    ("slow-leak", True): (True, False, 20, 20, (), ("grad_accum",), 0),
    ("slow-leak", False): (False, True, 14, 20, (14,) * 4, (), 4),
    ("spike", True): (True, False, 14, 14, (), ("grad_accum",), 0),
    ("spike", False): (False, True, 6, 14, (6,) * 4, (), 4),
    ("underestimate", True): (True, False, 10, 10, (), ("grad_accum",), 0),
    ("underestimate", False): (False, True, 0, 10, (0,) * 4, (), 4)}
AUTOPILOT_BYTES = (186838173760, 149470539008, 76231038080)
# the reference's plan for the harness cell at a drift ratio of 50 (no
# knob move is safe, so ``_reshard`` runs ``plan_min_chips``): the
# reshard candidate's mesh, remat, accumulation, schedule, microbatches,
# predicted bytes, cost and note
AUTOPILOT_RESHARD = ((("data", 1), ("model", 4), ("pipe", 2)), "block", 1,
                     "1f1b", 8, 5685696256, 2.0,
                     "4 -> 8 chips (data=1xmodel=4xpipe=2)")
# the real-step replay: smollm-360m, 8 x 2,048, AdamW, remat "block", 6
# steps, a checkpoint every 2 (keep 2), a failure injected at step 5
REPLAY_ARCH = "smollm-360m"
REPLAY_BATCH, REPLAY_SEQ, REPLAY_STEPS = 8, 2048, 6
REPLAY_EVERY, REPLAY_FAIL_AT = 2, 5

RESULT_COLUMNS = ("peak_bytes", "budget_bytes", "fits", "offload_bytes",
                  "overlap_slack_bytes", "pool_bytes", "draft_bytes",
                  "hit_saved_bytes", "arch_c", "chip_c", "mesh_c", "opt_c",
                  "remat_c", "sched_c", "srv_c", "off_c", "microbatches",
                  "grad_accum", "global_batch", "seq_len")


def say(*a):
    print(*a, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def run_text(cmd: list) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


# ---------------------------------------------------------------------------
# grids of the main path
# ---------------------------------------------------------------------------


def large_grid(assembly: str) -> SW.SweepGrid:
    """The paper's model over every 2-axis mesh factorization of
    64/128/256-chip pods x optimizer x remat x grad-accum x global batch x
    seq len x chip type: 124,416 cells."""
    return SW.SweepGrid(
        arch="llava15-7b", chips=(64, 128, 256),
        chip=("v5e", "v6e", "h100"),
        optimizers=(None, "adafactor", "adamw8bit"),
        remats=("none", "block", "dots"),
        grad_accums=(1, 2, 4, 8),
        global_batches=(8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                        8192, 16384),
        seq_lens=(512, 1024, 2048, 4096), backend="tpu",
        assembly=assembly)


def pipe_grid() -> SW.SweepGrid:
    """The large grid with a pipeline axis: 3-axis meshes capped at
    pipe=4, both schedules, microbatches 1/4/8: 1,959,552 cells."""
    g = large_grid("liveness")
    g.mesh_axes = ("data", "model", "pipe")
    g.max_axis = {"pipe": 4}
    g.schedules = ("1f1b", "gpipe")
    g.microbatches = (1, 4, 8)
    return g


NEW_ARCH_KNOBS = dict(
    chips=(64, 128, 256), chip=("v5e", "v6e", "h100"),
    optimizers=(None, "adamw8bit"), remats=("block", "dots"),
    grad_accums=(1, 2, 4, 8),
    global_batches=(8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                    16384),
    seq_lens=(512, 1024, 2048, 4096), backend="tpu")


def moe_epcp_grid() -> SW.SweepGrid:
    """Both MoE archs at their published widths (deepseek-v2-lite-16b with
    its MLA attention) over every legal expert x context x model x data
    split of the three pod sizes, liveness assembly: 299 meshes,
    1,377,792 cells."""
    return SW.SweepGrid(arch=("deepseek-v2-lite-16b", "arctic-480b"),
                        mesh_axes=("data", "model", "expert", "context"),
                        max_axis={"expert": 64, "context": 8},
                        assembly="liveness", **NEW_ARCH_KNOBS)


def new_archs_grid() -> SW.SweepGrid:
    """The dense MLA arch, the speech-text encoder-decoder and the hybrid
    over data x model x context meshes, legacy assembly: 78 meshes,
    539,136 cells."""
    return SW.SweepGrid(arch=("minicpm3-4b", "seamless-m4t-large-v2",
                              "zamba2-2.7b"),
                        mesh_axes=("data", "model", "context"),
                        max_axis={"context": 8}, assembly="legacy",
                        **NEW_ARCH_KNOBS)


# the mixes of the reference's serving tests: a 25 % prefill share over a
# 1:3 histogram of 512- and 2,048-token contexts, a 50 % prefill share at
# the cell's context, and none
FLEET_MIXES = ("0.25:512x1,2048x3", "0.5", "")
FLEET_DRAFTS = ("", "smollm-360m", "llama3.2-3b")


def fleet_grid(assembly: str) -> SW.SweepGrid:
    """The serving fleet of llava15-7b: decode over every 2-axis mesh of
    8-64 chips x chip type x batch x context, crossed with paged-KV block
    sizes, pool utilizations, prefix-cache hit rates, request mixes and
    speculative draft arches: 22 meshes x 72 serve specs, 152,064
    cells."""
    return SW.SweepGrid(
        arch="llava15-7b", chips=(8, 16, 32, 64), chip=("v5e", "v6e", "h100"),
        kind="decode", grad_accums=(1,),
        global_batches=(1, 2, 4, 8, 16, 32, 64, 128),
        seq_lens=(1024, 2048, 4096, 8192), block_sizes=(0, 16),
        utilizations=(1.0, 0.9), prefix_hit_rates=(0.0, 0.5),
        prefix_len=512, mixes=tuple(parse_mix(m) for m in FLEET_MIXES),
        draft_archs=FLEET_DRAFTS, backend="tpu", assembly=assembly)


FLEET_CELLS = 152064

# the reference's answers on these grids: the fit count and the int64 sum
# of peak_bytes that the JAX package's numpy engine
# (repro.core.sweep.SweepEngine().sweep(grid, engine="numpy")) gives on the
# same grids — under the same profiles for the calibrated ones;
# tests/test_torch_search.py, test_torch_sweep.py and test_torch_fleet.py
# hold slices of these grids to that engine on the CPU
MOE_EPCP_WANT = {"fit": 373348, "peak_sum": 661631732375195328}
NEW_ARCHS_WANT = {"fit": 283794, "peak_sum": 129472898769989760}
CAL_LEGACY_WANT = {"fit": 72352, "peak_sum": 13678326505963620}
GOLDEN_LEGACY_WANT = {"fit": 69171, "peak_sum": 13782902127276123}
CAL_PIPE_WANT = {"fit": 1199654, "peak_sum": 231198367000426587}
GOLDEN_PIPE_WANT = {"fit": 1225187, "peak_sum": 198650680808859066}
# the fleet's serving provenance is the same under both assemblies: the
# sums of pool_bytes, draft_bytes and hit_saved_bytes
FLEET_SERVE_SUMS = {"pool_bytes": 840082358126592,
                    "draft_bytes": 235669025519616,
                    "hit_saved_bytes": 70665715795968}
FLEET_WANT = {
    "legacy": {"fit": 135920, "peak_sum": 1874368055829504,
               **FLEET_SERVE_SUMS},
    "liveness": {"fit": 135920, "peak_sum": 1874320679253504,
                 **FLEET_SERVE_SUMS}}

# phase 4e: the calibration fitted on the bundled measurement fixture (the
# deterministic synthetic set, 144 cells of six families).  The JAX
# package's fit on the same fixture (NNLS through scipy) gives these
# profile hashes and, for the residual models fitted over them, these model
# hashes; tests/test_torch_calibrate.py holds the whole JSON on the CPU
CALIBRATION_FIXTURE = os.path.join(HERE, "benchmarks", "fixtures",
                                   "calibration_measurements.json")
CALIBRATION_WANT = {"legacy": ("837704a3226a942b", "a45dc699cb21105b"),
                    "liveness": ("e6cabd0dd686f8cf", "c06d2ccca886f30c")}
# the goldens' fixed non-identity profile (tests/golden/*.json, calibrated
# variant): a second profile the warm engine must not serve from the
# fitted profile's tables
GOLDEN_PROFILE = CalibrationProfile(
    coefficients={"static": 1.0417, "act_saved": 0.9313,
                  "act_transient": 1.1902, "overhead": 0.8641},
    chip_constant_bytes={"v5e": 134217728, "*": 33554432})


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions, on the card
# ---------------------------------------------------------------------------

MESH_AXES = ("data", "model", "expert", "context", "pipe")
LOGICAL = ("batch", "heads", "dmodel", "seq", "experts", "layers")


def random_program(rng, n_cells):
    """One randomized (dims, axes, sizes, rules, extra) instance: pipe in
    rules (never shards), the layers stack dim (excluded from the extra
    pass), multi-axis rules, size-1 axes, dims with no rule at all."""
    rules = {}
    for name in LOGICAL:
        k = rng.integers(0, 3)
        rules[name] = tuple(
            rng.choice(MESH_AXES, size=k, replace=False)) if k else ()
    n_dims = int(rng.integers(1, 5))
    axes = tuple(rng.choice(LOGICAL + (None,)) for _ in range(n_dims))
    dims = [rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 24, 64],
                       size=n_cells).astype(np.int64)
            for _ in range(n_dims)]
    sizes = {a: rng.choice([1, 1, 2, 4, 8], size=n_cells).astype(np.int64)
             for a in MESH_AXES}
    extra = tuple(rng.choice(MESH_AXES, size=int(rng.integers(0, 3)),
                             replace=False))
    return dims, axes, sizes, rules, extra


def random_request(rng):
    """One request of a table build: a random program over operands of one
    random broadcast family — scalars, rows (n,), columns (m, 1), full
    (m, n) and 3-dim shapes, one-cell shapes — with, by chance, empty
    programs and FSDP/ZeRO ``extra`` passes."""
    m, n = int(rng.integers(1, 6)), int(rng.integers(1, 3000))
    shapes = [[()], [(), (n,), (1,)],
              [(), (n,), (m, 1), (m, n), (1, n), (1, 1)],
              [(), (n,), (m, 1), (m, n), (2, 1, 1), (2, m, n), (1, 1, n)]
              ][int(rng.integers(0, 4))]
    dims, axes, _, rules, extra = random_program(rng, 1)

    def operand(values):
        shape = shapes[int(rng.integers(0, len(shapes)))]
        return rng.choice(values, size=shape).astype(np.int64)
    dims = [operand([1, 2, 3, 4, 6, 8, 12, 16, 24, 64, 2 ** 31 - 1,
                     2 ** 31, 3 * 2 ** 31, 2 ** 40]) for _ in dims]
    sizes = {a: operand([1, 1, 2, 4, 8, 2 ** 16]) for a in MESH_AXES}
    return dims, axes, sizes, rules, extra


def limit_request(n_dims, n_axes, dup=0):
    """``n_dims`` dims over ``n_axes`` mesh axes, every dim taking every
    axis in both passes: ``2 * n_dims * n_axes + dup`` steps."""
    mesh = [f"a{i}" for i in range(n_axes)]
    rules = {f"x{i}": tuple(mesh) + (mesh[0],) * (dup if i == 0 else 0)
             for i in range(n_dims)}
    dims = [np.array([2 ** 40, 2 ** 20, 2 ** 8 * 3, 1]) for _ in
            range(n_dims)]
    return dims, tuple(rules), {a: np.array([2, 2, 2, 2]) for a in mesh}, \
        rules, tuple(mesh)


def check_batched_shard_factor() -> tuple:
    """Packed builds of many requests: the batched kernel == its batched
    plain version on the card and == the host numpy path per request,
    exactly; bit-equal on a second launch; the kernel's limits equal the
    wrapper's, and requests beyond them or malformed buffers refused."""
    sf_design()
    rng = np.random.default_rng(SEED + 1)
    cases = max_err = 0
    builds = [[random_request(rng) for _ in range(k)]
              for k in (1, 2, 7, 60, 150, 400)]
    builds.append([limit_request(SF.MAX_DIMS, SF.MAX_AXES),
                   limit_request(1, 1)] + builds[2])
    for reqs in builds:
        batch = SF.ShardFactorBatch()
        keys = [batch.add(*r) for r in reqs]
        if not len(batch):
            continue
        dev = batch.pack().to(DEV)
        got = SF.shard_factor_batch(dev)
        again = SF.shard_factor_batch(dev)
        want = SF.shard_factor_batch_plain(dev)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        if err or not torch.equal(got, again):
            fail(f"batched shard_factor kernel != plain version or not "
                 f"bit-equal on relaunch ({len(batch)} requests, max abs "
                 f"diff {err})")
        answers = batch.resolve(DEV)
        for r, key in zip(reqs, keys):
            host = B.batch_shard_factor(*r)
            if key is not None and not np.array_equal(answers[key], host):
                fail("batched shard_factor != the host numpy path")
        cases += 1
    refused = 0
    for over in (limit_request(SF.MAX_DIMS + 1, 4),
                 limit_request(4, SF.MAX_AXES + 1),
                 limit_request(SF.MAX_DIMS, SF.MAX_AXES, dup=1),
                 out_of_range_request(dim=-12),
                 out_of_range_request(size=0),
                 out_of_range_request(dim=SF.DIM_LIMIT + 1)):
        batch = SF.ShardFactorBatch()
        batch.add(*over)
        try:
            batch.resolve(DEV)
        except ValueError:
            refused += 1
    dev = batch_of(builds[2]).to(DEV)
    strided = torch.zeros((2 * dev.operands.numel(),), dtype=torch.int64,
                          device=DEV)[::2]
    for bad in (dataclasses.replace(dev, operands=strided),
                dataclasses.replace(dev, tiles=dev.tiles.to(torch.int32)),
                dev.host):
        try:
            SF.shard_factor_batch(bad)
        except (TypeError, ValueError):
            refused += 1
    if refused != 9:
        fail(f"shard_factor_batch refused {refused} of 9 requests or "
             f"buffers the kernel does not take")
    return cases + refused, max_err


def out_of_range_request(dim: int = 16, size: int = 2):
    """A request whose middle cell holds ``dim`` / ``size``: a negative
    dim, a size of 0 or a dim past ``SF.DIM_LIMIT`` is refused."""
    return ([np.array([8, dim, 16])], ("batch",),
            {"data": np.array([2, size, 4])}, {"batch": ("data",)}, ())


def sf_design() -> dict:
    """The shard-factor kernel's limits and shape as csrc reports them,
    held equal to the wrapper's."""
    import ctypes
    lim = [ctypes.c_int() for _ in range(7)]
    _build.load().shard_factor_limits(*map(ctypes.byref, lim))
    got = [v.value for v in lim]
    if got[:6] != [SF.MAX_DIMS, SF.MAX_AXES, SF.MAX_STEPS, SF.TILE,
                   SF.THREADS, SF.CELLS]:
        fail(f"shard_factor kernel limits and shape {got} != the wrapper's")
    return {"design": "quotient form, persistent blocks",
            "threads": got[4], "cells_a_thread": got[5],
            "blocks_per_sm": got[6], "tile_cells": got[3]}


def check_sf_build() -> dict:
    """Phase 1's gate on the shard-factor kernel: its ptxas line present
    and no spill."""
    res = [r for name, r in _build.kernel_resources().items()
           if "shard_factor_batch_kernel" in name]
    if len(res) != 1:
        fail(f"ptxas reported {len(res)} shard_factor_batch_kernel lines")
    if res[0].get("spill_store_bytes") or res[0].get("spill_load_bytes"):
        fail(f"shard_factor_batch_kernel spills registers: {res[0]}")
    return {**sf_design(), "ptxas": res[0]}


def batch_of(reqs) -> "SF.Packed":
    batch = SF.ShardFactorBatch()
    for r in reqs:
        batch.add(*r)
    return batch.pack()


def check_shard_factor() -> dict:
    rng = np.random.default_rng(SEED)
    sizes_plan = [1] * 40 + [17] * 110 + [4608] * 50 + [1 << 20] * 8
    cases = max_err = 0
    for n in sizes_plan:
        while True:
            dims, axes, sizes, rules, extra = random_program(rng, n)
            steps, names = SF.pack_program(axes, rules, extra,
                                           axis_names=MESH_AXES)
            if steps:
                break
        d = torch.from_numpy(np.stack(dims)).to(DEV)
        s = torch.from_numpy(np.stack([sizes[a] for a in names])).to(DEV)
        got = SF.shard_factor_tensors(d, s, steps)
        want = SF.shard_factor_plain(d, s, steps)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        if err or got.dtype != torch.int64 or got.shape != (n,):
            fail(f"shard_factor kernel != plain version (n={n}, "
                 f"steps={steps}, max abs diff {err})")
        # the host-callable twin against the host numpy path
        if n <= 4608:
            host = B.batch_shard_factor(dims, axes, sizes, rules, extra)
            twin = SF.shard_factor(dims, axes, sizes, rules, extra,
                                   device=DEV)
            if not np.array_equal(host, twin):
                fail(f"shard_factor host twin != numpy path (n={n})")
        cases += 1
    # scalar / broadcast operands and the empty-program early return
    dims = [8, np.array([4, 8, 16], dtype=np.int64)]
    rules = {"batch": ("data",), "heads": ("model",)}
    sizes = {"data": 2, "model": np.array([1, 2, 4], dtype=np.int64)}
    for extra in ((), ("data",)):
        if not np.array_equal(
                SF.shard_factor(dims, ("batch", "heads"), sizes, rules,
                                extra, device=DEV),
                B.batch_shard_factor(dims, ("batch", "heads"), sizes,
                                     rules, extra)):
            fail("shard_factor broadcast operands disagree")
        cases += 1
    ones = SF.shard_factor([4, 6], (None, None), {"data": 2}, rules, (),
                           device=DEV)
    if not np.array_equal(ones, np.ones((), np.int64)):
        fail("shard_factor empty program must return ones")
    # what the kernel does not take raises (no fallback)
    d = torch.ones((2, 8), dtype=torch.int64, device=DEV)
    too_many = torch.ones((SF.MAX_DIMS + 1, 8), dtype=torch.int64,
                          device=DEV)
    for bad in (d.to(torch.int32), too_many):
        try:
            SF.shard_factor_tensors(bad, d, [(0, 0, 0)])
        except (TypeError, ValueError):
            cases += 1
        else:
            fail("shard_factor accepted an operand the kernel does not take")
    batched, err = check_batched_shard_factor()
    return {"name": "shard_factor", "ok": True, "cases": cases + batched,
            "max_abs_err": max(max_err, err)}


def check_segmented_cummax() -> dict:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    cases = max_err = 0
    for n_events in range(1, 13):
        for n in (1, 17, 1000, 4608, 1 << 20, 8 << 20):
            if n == 8 << 20 and n_events not in (1, 10, 12):
                continue
            d = torch.randint(-(1 << 40), 1 << 40, (n_events, n),
                              dtype=torch.int64, device=DEV, generator=gen)
            got = SC.segmented_cummax(d)
            want = SC.segmented_cummax_plain(d)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            max_err = max(max_err, err)
            if err or got.dtype != torch.int64 or got.shape != (n,):
                fail(f"segmented_cummax kernel != plain version "
                     f"(n_events={n_events}, n={n}, max abs diff {err})")
            cases += 1
            del d, got, want
    d = -torch.arange(1, 41, dtype=torch.int64, device=DEV).view(10, 4)
    if not torch.equal(SC.segmented_cummax(d), d[0]):
        fail("segmented_cummax: all-negative deltas must peak at event 0")
    cases += 1
    wide = torch.zeros((64, 10), dtype=torch.int64, device=DEV)
    for bad in (lambda: SC.segmented_cummax(wide.t()),          # strided
                lambda: SC.segmented_cummax(wide.to(torch.int32)),
                lambda: SC.segmented_cummax(wide[0])):
        try:
            bad()
        except (TypeError, ValueError):
            cases += 1
        else:
            fail("segmented_cummax accepted an input the kernel does not "
                 "take")
    return {"name": "segmented_cummax", "ok": True, "cases": cases,
            "max_abs_err": max_err}


# the reference's kernel-test cases (tests/test_kernels.py), the serving
# path's and the training path's own shapes: (B, Sq, Skv, H, Hkv, D, Dv,
# causal)
TRAIN_VIT_CASE = (TRAIN_BATCH, 577, 577, 16, 16, 64, 64, False)
TRAIN_LM_CASE = (TRAIN_BATCH, 2048, 2048, 32, 32, 128, 128, True)
# the enc-dec: cross-attention with Sq != Skv, and seamless's training /
# prefill shapes (the cross-attention's is the encoder's: 2,048 frames)
ENCDEC_XATTN_CASE = (2, 192, 320, 4, 4, 64, 64, False)
ENCDEC_ENC_CASE = (4, 2048, 2048, 16, 16, 64, 64, False)
ENCDEC_DEC_CASE = (4, 2048, 2048, 16, 16, 64, 64, True)
# the MLA and hybrid head-dim pairs: deepseek-v2-lite-16b's (192, 128) and
# minicpm3-4b's (96, 64), both with H = Hkv, and zamba2-2.7b's (80, 80)
# with GQA; each causal and not, at a ragged S, and as a q-offset
# continuation against a ragged kv length; then the main paths' shapes:
# deepseek's prefill and minicpm3's prefill and training, 4 x 2,048
MLA_PAIR_CASES = [
    (2, 200, 200, 4, 4, 192, 128, True),
    (1, 130, 130, 3, 3, 192, 128, False),
    (1, 65, 577, 2, 2, 192, 128, True),
    (2, 200, 200, 4, 4, 96, 64, True),
    (1, 130, 130, 3, 3, 96, 64, False),
    (1, 65, 577, 2, 2, 96, 64, True),
    (2, 200, 200, 8, 2, 80, 80, True),
    (1, 130, 130, 4, 4, 80, 80, False),
    (1, 65, 577, 4, 1, 80, 80, True),
]
DEEPSEEK_PREFILL_CASE = (4, 2048, 2048, 16, 16, 192, 128, True)
MINICPM3_CASE = (4, 2048, 2048, 40, 40, 96, 64, True)
# zamba2-2.7b's shared attention, prefill and training: 4 x 2,048, 32
# heads x 80, causal
ZAMBA2_CASE = (4, 2048, 2048, 32, 32, 80, 80, True)
FLASH_CASES = [
    (2, 256, 256, 4, 2, 64, 64, True),
    (1, 200, 200, 6, 3, 32, 32, True),
    (2, 1, 384, 4, 4, 64, 64, False),
    (1, 256, 256, 8, 1, 128, 64, True),
    (1, 130, 130, 2, 2, 64, 64, True),
    (2, 128, 256, 4, 2, 64, 64, True),
    (4, 577, 577, 16, 16, 64, 64, False),      # vision tower, serving
    (4, 1088, 1088, 32, 32, 128, 128, True),   # LM prefill
    TRAIN_VIT_CASE,                            # vision tower, training
    TRAIN_LM_CASE,                             # LM, training
    ENCDEC_XATTN_CASE,                         # enc-dec cross, Sq != Skv
    ENCDEC_ENC_CASE,                           # seamless encoder (and
                                               # cross), 4 x 2,048
    ENCDEC_DEC_CASE,                           # seamless decoder self
    *MLA_PAIR_CASES,
    DEEPSEEK_PREFILL_CASE,                     # deepseek-v2-lite-16b
    MINICPM3_CASE,                             # minicpm3-4b
    ZAMBA2_CASE,                               # zamba2-2.7b
]
# the pairs the kernels take beyond their compiled instances (zero-padded
# to FL.instance_for's pair: the reduced MLA archs' (24, 16), (20, 12) off
# the 16-byte grid, (112, 112)) and the (256, 256) instance, also padded
# from (256, 128), at a layer's size: 4 x 2,048 tokens, 8 q heads over 4
# kv heads, causal and not
WIDE_FLASH_CASES = [(4, 2048, 2048, 8, 4, d, dv, causal)
                    for d, dv in ((24, 16), (20, 12), (112, 112),
                                  (256, 256), (256, 128))
                    for causal in (True, False)]
TRAIN_ROWS = (TRAIN_BATCH * 2048, 4096)        # the LM's RMSNorms, training
RMSNORM_SHAPES = [(64, 128), (3, 50, 96), (2, 7, 33, 64), (5, 33),
                  (4 * 1088, 4096), (4, 1, 4096), TRAIN_ROWS,
                  # mamba2 serving: the prefill's gated norm over d_inner
                  # and block norm, the block norm in a decode step
                  (4 * 2000, 4096), (4 * 2000, 2048), (4, 1, 2048),
                  # seamless: 4 x 2,048 rows and a decode step at D 1,024
                  (4 * 2048, 1024), (4, 1, 1024),
                  # the MLA archs' kv_norm (deepseek 512, minicpm3 256),
                  # minicpm3's q_norm (768) and block norm (2,560), 4 x
                  # 2,048 rows, and a decode step's kv_norm
                  (4 * 2048, 512), (4 * 2048, 256), (4 * 2048, 768),
                  (4 * 2048, 2560), (4, 1, 512),
                  # zamba2-2.7b: the gated norm over d_inner 5,120 at 4 x
                  # 2,048 rows and in a decode step (its block and shared
                  # norms are minicpm3's 2,560)
                  (4 * 2048, 5120), (4, 1, 5120)]
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def case_key(case) -> str:
    """The key of one checked shape in a check's ``max_abs_err_by_case``
    (a name as it is)."""
    if isinstance(case, str):
        return case
    return "x".join(str(int(c)) for c in case)


def _note(errs: dict, by_case: dict, case, key: str, err: float) -> None:
    """Record one comparison's max |diff| overall and for its shape."""
    errs[key] = max(errs.get(key, 0.0), err)
    row = by_case.setdefault(case_key(case), {})
    row[key] = max(row.get(key, 0.0), err)


def _excess(got, want, tol) -> tuple:
    """(max |got - want|, max of |got - want| - tol * (1 + |want|)): the
    second is > 0 where allclose(atol=tol, rtol=tol) fails; both inf
    where a difference is NaN (``max`` returns NaN then, and a NaN
    compares false: it would pass unseen)."""
    d = (got.float() - want.float()).abs()
    worst = float(d.max())
    if worst != worst:
        return float("inf"), float("inf")
    return worst, float((d - tol * (1 + want.float().abs())).max())


def _refuses(call, errors=(TypeError, ValueError)) -> bool:
    try:
        call()
    except errors:
        return True
    return False


def unaligned_bf16(shape, gen=None) -> torch.Tensor:
    """A contiguous bf16 tensor that starts 2 bytes past a 16-byte
    boundary: zeros, or N(0, 1) values from ``gen``."""
    n = int(np.prod(shape))
    t = torch.zeros(n + 1, dtype=torch.bfloat16, device=DEV)[1:].view(shape)
    if gen is not None:
        t.copy_(torch.randn(shape, generator=gen, device=DEV))
    return t


def flash_layout_cases(gen) -> list:
    """Inputs the flash kernels refused before they took every layout, head
    dim and grid: a head-dim slice (D 48, strided), transposed views, the
    reduced MLA pair (24, 16), H or B above 65,535, bf16 views off the
    16-byte grid; each ``(name, dtype, q, k, v, dout)``, causal."""
    def rnd(*shape, dt):
        return torch.randn(shape, generator=gen, device=DEV).to(dt)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        base = [rnd(1, 8, 4, 64, dt=dt) for _ in range(4)]
        out.append(("head slice D 48", dt, *(t[..., :48] for t in base)))
        out.append(("transposed views", dt, *(rnd(1, 4, 8, 64, dt=dt)
                                              .transpose(1, 2)
                                              for _ in range(4))))
        out.append(("reduced MLA pair (24, 16)", dt,
                    *(rnd(2, 40, 4, w, dt=dt) for w in (24, 24, 16, 16))))
        out.append(("H 70,000", dt, *(rnd(1, 8, 70000, 16, dt=dt)
                                      for _ in range(4))))
        out.append(("B 70,000", dt, *(rnd(70000, 8, 1, 16, dt=dt)
                                      for _ in range(4))))
    out.append(("bf16 off the 16-byte grid", torch.bfloat16,
                *(unaligned_bf16((1, 8, 4, 64), gen) for _ in range(4))))
    return out


def flash_inputs(cases: list, gen, n: int):
    """``(case, dtype, causal, q_offset, q, k, v[, dout])`` for every case
    in fp32, then bf16; ``n`` tensors on the card drawn from ``gen`` one
    case at a time."""
    for dt in (torch.float32, torch.bfloat16):
        for case in cases:
            b, sq, skv, h, hkv, d, dv, causal = case
            shapes = ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, dv),
                      (b, sq, h, dv))[:n]
            yield (case, dt, causal, skv - sq if causal else 0,
                   *[torch.randn(sh, generator=gen, device=DEV).to(dt)
                     for sh in shapes])


def flash_layout_inputs(gen, n: int):
    """:func:`flash_layout_cases` as :func:`flash_inputs` gives its cases,
    each keyed by its name and dtype."""
    for name, dt, *tensors in flash_layout_cases(gen):
        yield (f"{name}, {dt}", dt, True, 0, *tensors[:n])


def wide_gen(seed: int) -> torch.Generator:
    """The generator of a check's widened shapes: its own seed, so that
    the earlier cases draw what they drew before those shapes existed."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 7)
    return gen


def check_flash() -> dict:
    """out and lse of the forward kernels against flash_fwd_plain, a second
    launch bit-equal, on FLASH_CASES, on WIDE_FLASH_CASES (pairs run
    zero-padded on ``FL.instance_for``'s, and the (256, 256) instance) and
    on the inputs the wrappers once refused; what the kernels do not take
    refused."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    wide = wide_gen(SEED)
    errs, by_case = {}, {}
    cases = 0
    for case, dt, causal, qoff, q, k, v in itertools.chain(
            flash_inputs(FLASH_CASES, gen, 3),
            flash_inputs(WIDE_FLASH_CASES, wide, 3),
            flash_layout_inputs(wide, 3)):
        out, lse = FL.flash_fwd(q, k, v, causal=causal, q_offset=qoff)
        again = FL.flash_fwd(q, k, v, causal=causal, q_offset=qoff)
        torch.cuda.synchronize()
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            fail(f"flash_fwd: two launches differ ({dt}, case {case})")
        p_out, p_lse = FL.flash_fwd_plain(q, k, v, causal=causal,
                                          q_offset=qoff)
        tol = TOLERANCE[dt]
        for what, got, want in (("out", out, p_out), ("lse", lse, p_lse)):
            err, over = _excess(got, want, tol)
            _note(errs, by_case, case, f"{what}_{str(dt).split('.')[-1]}",
                  err)
            if over > 0 or got.shape != want.shape:
                fail(f"flash_fwd kernel != plain version ({what}, {dt}, "
                     f"case {case}: max abs diff {err}, tolerance {tol})")
        cases += 1
        del q, k, v, out, lse, again, p_out, p_lse
    # what the kernels do not take raises (no fallback): float16, a head
    # dim above 256
    q = torch.zeros(1, 8, 4, 64, device=DEV)
    broad = torch.zeros(1, 8, 4, 288, device=DEV)
    bad = [lambda: FL.flash_fwd(q.half(), q.half(), q.half()),
           lambda: FL.flash_fwd(broad, broad, q),
           lambda: FL.flash_fwd(q, q, broad[..., :264])]
    for call in bad:
        if not _refuses(call):
            fail("flash_fwd accepted an input the kernel does not take")
        cases += 1
    return {"name": "flash_fwd", "ok": True, "cases": cases,
            "max_abs_err": max(errs.values()), "max_abs_err_by": errs,
            "max_abs_err_by_case": by_case,
            "deterministic": True,
            "tolerance": {"float32": 2e-5, "bfloat16": 2e-2}}


def check_rmsnorm() -> dict:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 1)
    errs, by_case = {}, {}
    cases = 0
    for dt in (torch.float32, torch.bfloat16):
        for shape in RMSNORM_SHAPES:
            x = torch.randn(shape, generator=gen, device=DEV).to(dt)
            sc = torch.randn(shape[-1:], generator=gen, device=DEV).to(dt)
            # a row-offset view: contiguous, but off the 16-byte grid
            # when D * elt is not a multiple of 16 (the scalar path)
            for xs in (x, x.view(-1, shape[-1])[1:]):
                got = RN.rmsnorm_fwd(xs, sc, 1e-5)
                torch.cuda.synchronize()
                want = RN.rmsnorm_fwd_plain(xs, sc, 1e-5)
                err, over = _excess(got, want, TOLERANCE[dt])
                _note(errs, by_case, xs.shape, str(dt).split(".")[-1], err)
                if over > 0 or got.shape != want.shape:
                    fail(f"rmsnorm_fwd kernel != plain version ({dt}, "
                         f"{tuple(xs.shape)}: max abs diff {err})")
                cases += 1
    x = torch.zeros(8, 64, device=DEV)
    for call in (lambda: RN.rmsnorm_fwd(x.t(), x[0]),
                 lambda: RN.rmsnorm_fwd(x.half(), x[0].half()),
                 lambda: RN.rmsnorm_fwd(x, x[0].bfloat16())):
        if not _refuses(call):
            fail("rmsnorm_fwd accepted an input the kernel does not take")
        cases += 1
    return {"name": "rmsnorm_fwd", "ok": True, "cases": cases,
            "max_abs_err": max(errs.values()), "max_abs_err_by": errs,
            "max_abs_err_by_case": by_case,
            "tolerance": {"float32": 2e-5, "bfloat16": 2e-2}}


# the backward's cases: the reference's six, the training path's two
# attention shapes (the LM's causal 2,048 and the ViT's ragged 577) and
# the reduced configs' head dim 16 (the reduced card-vs-CPU training run)
FLASH_BWD_CASES = FLASH_CASES[:6] + [TRAIN_VIT_CASE, TRAIN_LM_CASE,
                                     (2, 70, 70, 2, 2, 16, 16, True),
                                     ENCDEC_XATTN_CASE, ENCDEC_ENC_CASE,
                                     ENCDEC_DEC_CASE, *MLA_PAIR_CASES,
                                     MINICPM3_CASE, ZAMBA2_CASE]
RMSNORM_BWD_SHAPES = RMSNORM_SHAPES[:4] + [TRAIN_ROWS, (40, 96),
                                           (4 * 2048, 1024),
                                           # minicpm3-4b's training norms
                                           (4 * 2048, 768), (4 * 2048, 256),
                                           (4 * 2048, 2560),
                                           # zamba2-2.7b's gated norm
                                           (4 * 2048, 5120)]
# phase 2b's: past the shared-memory partial row (RN.BWD_SMEM_D)
WIDE_RMSNORM_BWD_SHAPES = [(4 * 2048, 16384)]
BWD_TOLERANCE = {"flash": {torch.float32: 5e-4, torch.bfloat16: 2e-2},
                 "rmsnorm": {torch.float32: 1e-4, torch.bfloat16: 2e-2}}


def _bwd_excess(got, want, dt, tol) -> tuple:
    """(max |got - want|, excess): fp32 as allclose(atol=rtol=tol), bf16
    against tol times the compared tensor's scale (its max magnitude)."""
    if dt == torch.float32:
        return _excess(got, want, tol)
    d = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    worst = float(d.max())
    if worst != worst:
        return float("inf"), float("inf")
    return worst, worst - tol * scale


def check_flash_bwd() -> dict:
    """dq, dk and dv of the two kernels against flash_bwd_plain, a second
    launch bit-equal to the first, on FLASH_BWD_CASES, WIDE_FLASH_CASES and
    the inputs once refused (the passes alone on the bf16 views off the
    grid); the autograd Function's gradients equal the wrapper's."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 3)
    wide = wide_gen(SEED + 3)
    errs, by_case = {}, {}
    cases = 0
    for case, dt, causal, qoff, q, k, v, do in itertools.chain(
            flash_inputs(FLASH_BWD_CASES, gen, 4),
            flash_inputs(WIDE_FLASH_CASES, wide, 4),
            flash_layout_inputs(wide, 4)):
        tol = BWD_TOLERANCE["flash"][dt]
        out, lse = FL.flash_fwd(q, k, v, causal=causal, q_offset=qoff)
        got = FL.flash_bwd(q, k, v, out, lse, do, causal=causal,
                           q_offset=qoff)
        again = FL.flash_bwd(q, k, v, out, lse, do, causal=causal,
                             q_offset=qoff)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            fail(f"flash_bwd: two launches differ ({dt}, case {case})")
        if isinstance(case, str) and case.startswith("bf16 off"):
            dq, delta = FL.flash_bwd_dq(q, k, v, out, lse, do)
            alone = (dq,) + FL.flash_bwd_dkv(q, k, v, lse, do, delta)
            if not all(torch.equal(a, c) for a, c in zip(got, alone)):
                fail("flash_bwd_dq / flash_bwd_dkv alone != flash_bwd")
        want = FL.flash_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                  q_offset=qoff)
        for what, g, w in zip(("dq", "dk", "dv"), got, want):
            err, over = _bwd_excess(g, w, dt, tol)
            _note(errs, by_case, case, f"{what}_{str(dt).split('.')[-1]}",
                  err)
            if over > 0 or g.shape != w.shape or g.dtype != w.dtype:
                fail(f"flash_bwd kernels != plain version ({what}, {dt}, "
                     f"case {case}: max abs diff {err}, tolerance {tol})")
        cases += 1
        del q, k, v, do, out, lse, got, again, want
    # the autograd Function launches the kernels and returns their result
    q, k, v, do = (torch.randn(2, 130, 4, 64, generator=gen, device=DEV)
                   .to(torch.bfloat16) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n_dq, n_dkv = FL.dq_launches, FL.dkv_launches
    grads = torch.autograd.grad(OPS.flash_attention(*leaves, True), leaves,
                                do)
    if (FL.dq_launches - n_dq, FL.dkv_launches - n_dkv) != (1, 1):
        fail("ops.flash_attention's backward did not launch each backward "
             "kernel once")
    out, lse = FL.flash_fwd(q, k, v, causal=True)
    want = FL.flash_bwd(q, k, v, out, lse, do, causal=True)
    if not all(torch.equal(g, w) for g, w in zip(grads, want)):
        fail("ops.flash_attention's gradients differ from flash_bwd's")
    cases += 1
    # what the kernels do not take raises (no fallback): float16, a delta
    # of another shape, a head dim above 256
    z = torch.zeros(1, 8, 4, 64, device=DEV)
    lz = torch.zeros(1, 4, 8, device=DEV)
    broad = torch.zeros(1, 8, 4, 288, device=DEV)
    bad = [lambda: FL.flash_bwd(z.half(), z.half(), z.half(), z.half(), lz,
                                z.half()),
           lambda: FL.flash_bwd_dkv(z, z, z, lz, z, lz[:, :2]),
           lambda: FL.flash_bwd(broad, broad, z, z, lz, z)]
    for call in bad:
        if not _refuses(call):
            fail("flash_bwd accepted an input the kernels do not take")
        cases += 1
    return {"name": "flash_bwd", "ok": True, "cases": cases,
            "max_abs_err": max(errs.values()), "max_abs_err_by": errs,
            "max_abs_err_by_case": by_case,
            "deterministic": True,
            "tolerance": {"float32": 5e-4, "bfloat16": "2e-2 of scale"}}


def rmsnorm_bwd_inputs(shapes: list, gen):
    """``(dtype, x, scale, dy)`` for every shape in fp32, then bf16, drawn
    from ``gen`` one shape at a time."""
    for dt in (torch.float32, torch.bfloat16):
        for shape in shapes:
            yield (dt, *[torch.randn(sh, generator=gen, device=DEV).to(dt)
                         for sh in (shape, shape[-1:], shape)])


def check_rmsnorm_bwd() -> dict:
    """dx and dscale of the backward kernel against rmsnorm_bwd_plain, a
    second launch bit-equal, also on row-offset views, on
    RMSNORM_BWD_SHAPES and WIDE_RMSNORM_BWD_SHAPES (past the shared-memory
    partial row); the autograd Function's backward one launch; what the
    kernel does not take refused."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 4)
    errs, by_case = {}, {}
    cases = 0
    for dt, x, sc, dy in itertools.chain(
            rmsnorm_bwd_inputs(RMSNORM_BWD_SHAPES, gen),
            rmsnorm_bwd_inputs(WIDE_RMSNORM_BWD_SHAPES, wide_gen(SEED + 4))):
        tol = BWD_TOLERANCE["rmsnorm"][dt]
        D = x.shape[-1]
        # a row-offset view: off the 16-byte grid where D * elt is not a
        # multiple of 16 (the scalar path)
        for xs, dys in ((x, dy), (x.view(-1, D)[1:], dy.view(-1, D)[1:])):
            got = RN.rmsnorm_bwd(xs, sc, dys, 1e-5)
            again = RN.rmsnorm_bwd(xs, sc, dys, 1e-5)
            torch.cuda.synchronize()
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                fail(f"rmsnorm_bwd: two launches differ ({dt}, "
                     f"{tuple(xs.shape)})")
            want = RN.rmsnorm_bwd_plain(xs, sc, dys, 1e-5)
            for what, g, w in zip(("dx", "dscale"), got, want):
                err, over = _excess(g, w, tol)
                _note(errs, by_case, xs.shape,
                      f"{what}_{str(dt).split('.')[-1]}", err)
                if over > 0 or g.shape != w.shape or g.dtype != w.dtype:
                    fail(f"rmsnorm_bwd kernel != plain version ({what}, "
                         f"{dt}, {tuple(xs.shape)}: max abs diff {err})")
            cases += 1
        del x, sc, dy
    x = torch.randn(6, 64, generator=gen, device=DEV)
    sc = torch.randn(64, generator=gen, device=DEV)
    dy = torch.randn(6, 64, generator=gen, device=DEV)
    xl, sl = x.clone().requires_grad_(), sc.clone().requires_grad_()
    n = RN.bwd_launches
    grads = torch.autograd.grad(OPS.rmsnorm(xl, sl), (xl, sl), dy)
    if RN.bwd_launches - n != 1 or not all(
            torch.equal(g, w) for g, w in zip(grads, RN.rmsnorm_bwd(x, sc,
                                                                   dy))):
        fail("ops.rmsnorm's backward is not one launch of rmsnorm_bwd")
    cases += 1
    for call in (lambda: RN.rmsnorm_bwd(x.t(), x[:, 0], x.t()),
                 lambda: RN.rmsnorm_bwd(x.half(), sc.half(), dy.half()),
                 lambda: RN.rmsnorm_bwd(x, sc, dy.bfloat16())):
        if not _refuses(call):
            fail("rmsnorm_bwd accepted an input the kernel does not take")
        cases += 1
    return {"name": "rmsnorm_bwd", "ok": True, "cases": cases,
            "max_abs_err": max(errs.values()), "max_abs_err_by": errs,
            "max_abs_err_by_case": by_case,
            "deterministic": True,
            "tolerance": {"float32": 1e-4, "bfloat16": 2e-2}}


# the SSD's cases: the reference's three kernel cases (tests/test_kernels.py),
# a prompt shorter than the chunk, and the serving path's full-width prefill
# (4 x 2,000 tokens, 64 heads x 64, d_state 128, chunk 256: a ragged
# 208-token last chunk); (b, S, H, P, N, chunk)
SERVE_SSD_CASE = (4, 2000, 64, 64, 128, 256)
# zamba2-2.7b's prefill: 4 x 2,048 tokens, 80 heads x 64, d_state 64
ZAMBA2_SSD_CASE = (4, 2048, 80, 64, 64, 256)
# the reference's three cases, S < chunk, the serving shape, its batch-1
# twin (64 blocks: under half the card), and a state width that is not a
# multiple of 16 (the bf16 kernel pads it; 8-byte copies) at head dim 128
SSD_CASES = [(2, 128, 4, 16, 32, 32), (1, 96, 2, 32, 16, 32),
             (1, 64, 1, 64, 64, 64), (2, 40, 3, 16, 16, 64), SERVE_SSD_CASE,
             (1,) + SERVE_SSD_CASE[1:], (2, 75, 3, 128, 20, 32),
             ZAMBA2_SSD_CASE]
# the shapes the kernels take beyond their instances (SSD.kernel_plan), at
# a layer's size, 4 x 2,048 tokens: P 80 as slabs of 64 and 16, P 256 as
# two 128-column slabs of one launch, N 256 at P 64 (fp32: two 32-column
# slabs), N 512 (fp32: walked in two pieces; bf16: one launch)
WIDE_SSD_CASES = [(4, 2048, 32, 80, 64, 256), (4, 2048, 16, 256, 128, 256),
                  (4, 2048, 64, 64, 256, 256), (4, 2048, 64, 16, 512, 256)]
SSD_TOLERANCE = 1e-4          # fp32 y and state; bf16 state, of its scale
SSD_BF16_Y_TOLERANCE = 2e-2   # bf16 y, of its scale (one rounding of y)


def ssd_inputs(case, gen, dtype, shift: float = None):
    """x, dt (post-softplus), A (< 0), B, C on the card.  The reference's
    test distribution (dt ~ softplus(N(0, 1))) on its own cases; at the
    serving widths (mamba2's at any batch, zamba2's) and the layer-size
    WIDE_SSD_CASES dt ~ softplus(N(0, 1) - 3), ~0.05, so the state carries
    across chunks as a served model's does (``shift`` overrides)."""
    b, S, H, P, N, _ = case
    if shift is None:
        shift = 3.0 if case[1:] in (SERVE_SSD_CASE[1:], ZAMBA2_SSD_CASE[1:]) \
            or case in WIDE_SSD_CASES else 0.0
    x = torch.randn(b, S, H, P, generator=gen, device=DEV) * 0.5
    dt = F.softplus(torch.randn(b, S, H, generator=gen, device=DEV) - shift)
    A = -torch.exp(torch.randn(H, generator=gen, device=DEV) * 0.3)
    Bm = torch.randn(b, S, N, generator=gen, device=DEV) * 0.5
    Cm = torch.randn(b, S, N, generator=gen, device=DEV) * 0.5
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


def ssd_recurrence64(x, dt, A, B, C) -> tuple:
    """The SSD's sequential recurrence in float64 -> (y, final state)."""
    x, dt, A, B, C = (t.double() for t in (x, dt, A, B, C))
    st = x.new_zeros((x.shape[0], x.shape[2], x.shape[3], B.shape[-1]))
    ys = []
    for t in range(x.shape[1]):
        st = st * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bn,bhp,bh->bhpn", B[:, t], x[:, t], dt[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", st, C[:, t]))
    return torch.stack(ys, 1), st


# the fp32 kernel at a state of 256 under the reference test's dt
# (softplus of N(0, 1)), at WIDE_SSD_CASES' N-256 shape: over a 256-token
# chunk a_cum runs to about -180, and exp of its differences carries
# fp32's rounding of those running sums (the kernel's and the plain
# version's, summed in other orders), so the two part by more than 1e-4
# (about 8e-4 at this shape on an H100 80GB HBM3).  Both are held to the
# float64 recurrence: the kernel within max(SSD_TOLERANCE,
# FP64_WITNESS_RATIO x the plain version's distance), each of its
# tensor's scale
SSD_WITNESS_CASE = (4, 2048, 64, 64, 256, 256)


def ssd_case_inputs(cases: list, gen):
    """``(case, (x, dt, A, B, C), chunk)`` for every case in fp32, then
    bf16, drawn from ``gen`` one case at a time."""
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases:
            yield case, ssd_inputs(case, gen, dtype), case[-1]


def ssd_layout_inputs(gen):
    """The inputs the kernels once refused, as :func:`ssd_case_inputs`
    gives its cases (chunk 8): a head-dim slice (P 48: slabs of 32 and 16
    read in place), a state width off the multiples of 4 (padded), a
    strided head dim, bf16 x off the 16-byte grid and B off the 8-byte
    grid (copied), batch 70,000."""
    x, dtv, A, Bm, Cm = ssd_inputs((1, 8, 2, 64, 16, 8), gen, torch.float32)
    xb, Bb, Cb = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    ux, uB = unaligned_bf16(x.shape), unaligned_bf16(Bm.shape)
    ux.copy_(xb)
    uB.copy_(Bb)
    for name, args in (
            ("head slice P 48", (x[..., :48], dtv, A, Bm, Cm)),
            ("state width 14", (x, dtv, A, Bm[..., :14], Cm[..., :14])),
            ("strided head dim", (x.transpose(2, 3).contiguous()
                                  .transpose(2, 3), dtv, A, Bm, Cm)),
            ("bf16 x off the grid", (ux, dtv, A, Bb, Cb)),
            ("bf16 B off the grid", (xb, dtv, A, uB, Cb)),
            ("batch 70,000", ssd_inputs((70000, 8, 2, 16, 16, 8), gen,
                                        torch.bfloat16))):
        yield name, args, 8


def ssd_witness() -> dict:
    """The fp32 kernel and the plain version at SSD_WITNESS_CASE under the
    reference test's dt, each against the float64 recurrence (of its
    tensor's scale); a second launch bit-equal."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 13)
    args = ssd_inputs(SSD_WITNESS_CASE, gen, torch.float32, shift=0.0)
    chunk = SSD_WITNESS_CASE[-1]
    got = SSD.ssd_scan(*args, chunk=chunk)
    again = SSD.ssd_scan(*args, chunk=chunk)
    plain = SSD.ssd_scan_plain(*args, chunk=chunk)
    exact = ssd_recurrence64(*args)
    witness = {}
    for i, what in enumerate(("y", "state")):
        scale = float(exact[i].abs().max())
        k_err = float((got[i].double() - exact[i]).abs().max()) / scale
        p_err = float((plain[i].double() - exact[i]).abs().max()) / scale
        witness[what] = {"kernel_vs_fp64": k_err, "plain_vs_fp64": p_err,
                         "kernel_vs_plain": _excess(got[i], plain[i],
                                                    SSD_TOLERANCE)[0]}
        if k_err > max(SSD_TOLERANCE, FP64_WITNESS_RATIO * p_err) or \
                not torch.equal(got[i], again[i]):
            fail(f"ssd_scan fp32 kernel at {SSD_WITNESS_CASE}: {what} "
                 f"{k_err} of its scale from float64 against the plain "
                 f"version's {p_err}, or a second launch differs")
    return {"case": SSD_WITNESS_CASE, **witness}


def check_ssd() -> dict:
    """y and the final state of the kernels (fp32: FMA, bf16: the wgmma
    state pass and chunk scan) against ssd_scan_plain on SSD_CASES, on WIDE_SSD_CASES
    (``SSD.kernel_plan``'s slabs and N pieces) and on the inputs once
    refused; a second launch bit-equal; x, B and C read in place through a
    token stride (views into one conv-output buffer, as the model hands
    them) bit-equal to contiguous copies; the fp32 kernel under the
    reference test's dt against float64 (:func:`ssd_witness`); what the
    kernels do not take refused."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 5)
    wide = wide_gen(SEED + 5)
    errs, by_case = {}, {}
    cases = 0
    for case, args, chunk in itertools.chain(
            ssd_case_inputs(SSD_CASES, gen),
            ssd_case_inputs(WIDE_SSD_CASES, wide), ssd_layout_inputs(wide)):
        in_dt = args[0].dtype
        tag = str(in_dt).split(".")[-1]
        y, st = SSD.ssd_scan(*args, chunk=chunk)
        y2, st2 = SSD.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(st, st2)):
            fail(f"ssd_scan: two launches differ ({in_dt}, case {case})")
        py, pst = SSD.ssd_scan_plain(*args, chunk=chunk)
        for what, got, want in (("y", y, py), ("state", st, pst)):
            if in_dt == torch.float32:
                err, over = _excess(got, want, SSD_TOLERANCE)
            else:
                tol = SSD_BF16_Y_TOLERANCE if what == "y" else SSD_TOLERANCE
                err, over = _bwd_excess(got, want, in_dt, tol)
            _note(errs, by_case, case, f"{what}_{tag}", err)
            if over > 0 or got.shape != want.shape or \
                    got.dtype != want.dtype or \
                    not bool(torch.isfinite(got).all()):
                fail(f"ssd_scan kernel != plain version ({what}, {in_dt}, "
                     f"case {case}: max abs diff {err})")
        if case == SERVE_SSD_CASE:
            x, dtv, A, Bm, Cm = args
            b, S, H, P, N, _ = case
            buf = torch.cat([x.reshape(b, S, H * P), Bm, Cm], dim=-1)
            xv = buf[..., :H * P].view(b, S, H, P)
            Bv, Cv = buf[..., H * P:H * P + N], buf[..., H * P + N:]
            yv, stv = SSD.ssd_scan(xv, dtv, A, Bv, Cv, chunk=chunk)
            torch.cuda.synchronize()
            if not (torch.equal(yv, y) and torch.equal(stv, st)):
                fail(f"ssd_scan on strided views != on contiguous copies "
                     f"({in_dt})")
            del buf, xv, Bv, Cv, yv, stv
        cases += 1
        del args, y, st, y2, st2, py, pst
    witness = ssd_witness()
    cases += 1
    # what the kernels do not take raises (no fallback): float16, a chunk
    # past shared memory (fp32; bf16, whose state pass holds a chunk's
    # a_cum and w), a head above 256, a state above 512
    x, dtv, A, Bm, Cm = ssd_inputs((1, 8, 2, 64, 16, 8), gen, torch.float32)
    for call in (lambda: SSD.ssd_scan(x.half(), dtv, A, Bm.half(),
                                      Cm.half()),
                 lambda: SSD.ssd_scan(*ssd_inputs(
                     (1, 30000, 2, 64, 128, 1), gen, torch.float32),
                     chunk=30000),
                 lambda: SSD.ssd_scan(*ssd_inputs(
                     (1, 12000, 2, 64, 128, 1), gen, torch.bfloat16),
                     chunk=12000),
                 lambda: SSD.ssd_scan(*ssd_inputs(
                     (1, 8, 2, 264, 16, 8), gen, torch.float32)),
                 lambda: SSD.ssd_scan(*ssd_inputs(
                     (1, 8, 2, 16, 520, 8), gen, torch.float32))):
        if not _refuses(call):
            fail("ssd_scan accepted an input the kernel does not take")
        cases += 1
    # the model's entry point launches the kernel and returns its result
    n = SSD.launches
    got = OPS.ssd_scan(x, dtv, A, Bm, Cm, chunk=4)
    want = SSD.ssd_scan(x, dtv, A, Bm, Cm, chunk=4)
    if SSD.launches - n != 2 or not all(
            torch.equal(g, w) for g, w in zip(got, want)):
        fail("ops.ssd_scan is not one launch of the SSD kernel")
    cases += 1
    return {"name": "ssd_scan", "ok": True, "cases": cases,
            "max_abs_err": max(errs.values()), "max_abs_err_by": errs,
            "max_abs_err_by_case": by_case, "deterministic": True,
            "fp64_witness": witness,
            "tolerance": {"float32": SSD_TOLERANCE,
                          "bfloat16": {"y": "2e-2 of scale",
                                       "state": "1e-4 of scale"}}}


# ---------------------------------------------------------------------------
# phases 3-4: the sweeps
# ---------------------------------------------------------------------------


class ShapeLog:
    """Remembers, per sweep kernel, the largest operands the sweeps handed
    to its wrapper — the packed table build with the most cells (its host
    buffers), the largest delta stack (a device copy, moved to the host by
    :meth:`to_host` once the sweeps are over) — so phase 7 times the
    kernels at the main path's shapes, and the serving and training
    phases' allocator peaks hold nothing of the sweeps."""

    def __init__(self):
        self.sf = None          # SF.Packed (host)
        self.sf_small = None    # the searches' first packed build (host)
        self.sc = None          # deltas (host)
        self._sf, self._sc = SF.shard_factor_batch, SC.segmented_cummax

    @contextlib.contextmanager
    def first_build(self):
        """A context in which the first packed table build handed to the
        wrapper is kept as ``sf_small`` (the searches' small cold
        builds)."""
        real = SF.shard_factor_batch

        def sf(b):
            if self.sf_small is None:
                self.sf_small = b.host
            return real(b)
        SF.shard_factor_batch = sf
        try:
            yield
        finally:
            SF.shard_factor_batch = real

    def __enter__(self):
        def sf(b):
            if self.sf is None or b.host.n_out > self.sf.n_out:
                self.sf = b.host
            return self._sf(b)

        def sc(deltas):
            if self.sc is None or deltas.numel() > self.sc.numel():
                self.sc = deltas.clone()
            return self._sc(deltas)
        SF.shard_factor_batch, SC.segmented_cummax = sf, sc
        return self

    def __exit__(self, *exc):
        SF.shard_factor_batch, SC.segmented_cummax = self._sf, self._sc

    def to_host(self) -> None:
        if self.sc is not None:
            self.sc = self.sc.cpu()


def zero_counts() -> None:
    """Every kernel's launch counter to 0, just before a path runs."""
    SF.launches = SC.launches = FL.launches = RN.launches = 0
    FL.dq_launches = FL.dkv_launches = RN.bwd_launches = SSD.launches = 0


def model_counts() -> dict:
    """The launch counters of the model path's five kernels."""
    return {"flash_fwd": FL.launches, "flash_dq": FL.dq_launches,
            "flash_dkv": FL.dkv_launches, "rmsnorm_fwd": RN.launches,
            "rmsnorm_bwd": RN.bwd_launches}


# the bf16 tensor-core kernels: name in the kernels line -> the pass
# (FL.wgmma_plan's kernel); the CUDA kernel of each pass, and its number
# in csrc's flash_wgmma_plan
MMA_KERNELS = {"flash_fwd": "fwd", "flash_dq": "dq", "flash_dkv": "dkv"}
FLASH_KERNEL = {"fwd": "flash_fwd_kernel_wgmma",
                "dq": "flash_bwd_dq_kernel_wgmma",
                "dkv": "flash_bwd_dkv_kernel_wgmma"}
PLAN_NUMBER = {"fwd": 0, "dkv": 1, "dq": 2}
# the bf16 SSD's two kernels (csrc/ssd_wgmma.cu): the state pass, then the
# chunk scan, both launched by every bf16 program of SSD.kernel_plan
SSD_KERNELS = ("ssd_state_kernel_wgmma", "ssd_scan_kernel_wgmma")
SSD_THREADS = {"ssd_state_kernel_wgmma": 192, "ssd_scan_kernel_wgmma": 160}


def mma_resources() -> dict:
    """``ptxas -v``'s registers, spills and stack of every instance of the
    tensor-core kernels (all wgmma), by ``kernel<D,Dv>`` (flash) /
    ``kernel<P>`` (SSD)."""
    out = {}
    kernels = list(FLASH_KERNEL.values()) + list(SSD_KERNELS)
    for name, r in _build.kernel_resources().items():
        for kern in kernels:
            if re.search(kern + r"I", name):
                dims = re.findall(r"Li(\d+)E", name)
                out[f"{kern}<{','.join(dims)}>"] = r
    return out


def flash_design(which: str, di: int, dvi: int) -> dict:
    """The design, CUDA kernel, tile, stages, threads, ptxas line and
    shared memory of the bf16 pass ``which`` at the compiled pair (di,
    dvi)."""
    kern = FLASH_KERNEL[which]
    plan = FL.wgmma_plan(which, di, dvi)
    return {"design": plan["design"], "kernel": kern,
            "tile": list(plan["tile"]), "stages": plan["stages"],
            "threads": plan["threads"],
            "ptxas": mma_resources().get(f"{kern}<{di},{dvi}>"),
            "smem_bytes_per_block": plan["smem_bytes"]}


# the (P, N, chunk) points at which csrc's ssd_wgmma_plan is held to
# SSD.wgmma_smem: every compiled head width at the serving state widths,
# N 512 and a chunk past the serving one
SSD_PLAN_POINTS = [(P, N, chunk) for P in SSD.HEAD_DIMS
                   for N, chunk in ((64, 256), (128, 256), (512, 256),
                                    (128, 8), (128, 7872))]


def check_ssd_build(lib, res: dict) -> list:
    """The bf16 SSD's share of phase 1's gate: both kernels at every
    compiled head width built without a spill and without a wgmma
    serialisation note (C75xx "Potential Performance Loss"), and csrc's
    ssd_wgmma_plan (shared memory of each kernel, heads a scan block, ring
    slots) equal to SSD.wgmma_smem at ``SSD_PLAN_POINTS``."""
    import ctypes
    checked = []
    for kern in SSD_KERNELS:
        for P in SSD.HEAD_DIMS:
            name = f"{kern}<{P}>"
            r = res.get(name)
            if r is None:
                fail(f"ptxas reported nothing for {name}")
            if r.get("spill_store_bytes") or r.get("spill_load_bytes"):
                fail(f"{name} spills registers: {r}")
            checked.append(name)
    notes = [w for w in _build.ptxas_warnings()
             if "Performance Loss" in w and "ssd_" in w]
    if notes:
        fail(f"ptxas serialised the SSD's wgmma: {notes}")
    for P, N, chunk in SSD_PLAN_POINTS:
        got = (ctypes.c_int * 5)()
        if lib.ssd_wgmma_plan(P, N, chunk, got):
            fail(f"ssd_wgmma_plan refused {(P, N, chunk)}")
        want = SSD.wgmma_smem(P, N, chunk)
        want = [want["state"], want["scan"], want["heads"], want["b_slots"],
                want["x_slots"]]
        if list(got) != want:
            fail(f"SSD {(P, N, chunk)}: csrc's plan {list(got)} != "
                 f"ssd.wgmma_smem's {want}")
    return checked


def check_wgmma_build() -> dict:
    """Phase 1's gate on the wgmma kernels: every compiled instance
    (``FL.HEAD_DIMS``) built (its ptxas line present) without a spill, and
    its plan in csrc/wgmma_plan.cuh (rows, step rows, stages, sweeps,
    shared memory) equal to flash_attention.py's wgmma_plan; the SSD's
    (:func:`check_ssd_build`).  (A C7508 "setmaxnreg ignored" warning
    fails the build itself.)"""
    import ctypes
    lib = _build.load()
    res = mma_resources()
    checked = check_ssd_build(lib, res)
    for which, k in PLAN_NUMBER.items():
        for pair in FL.HEAD_DIMS:
            name = f"{FLASH_KERNEL[which]}<{pair[0]},{pair[1]}>"
            r = res.get(name)
            if r is None:
                fail(f"ptxas reported nothing for {name}")
            if r.get("spill_store_bytes") or r.get("spill_load_bytes"):
                fail(f"{name} spills registers: {r}")
            got = (ctypes.c_int * 5)()
            if lib.flash_wgmma_plan(k, pair[0], pair[1], got):
                fail(f"flash_wgmma_plan refused {which} {pair}")
            plan = FL.wgmma_plan(which, *pair)
            want = [*plan["tile"], plan["stages"], plan["sweeps"],
                    plan["smem_bytes"]]
            if list(got) != want:
                fail(f"{which} {pair}: csrc's plan {list(got)} != "
                     f"flash_attention.wgmma_plan's {want}")
            checked.append(name)
    return {"wgmma_instances": checked,
            "ptxas_notes": [w for w in _build.ptxas_warnings()
                            if "Performance Loss" in w]}


def timed_sweep(engine, grid) -> tuple:
    """The sweep on the card, timed; its phase split, and the time the
    interpreter's garbage collector took inside it (``gc_s``, by
    generation ``gc_runs``: a collection can land in any timed phase)."""
    gc_time = {"s": 0.0, "runs": [0, 0, 0]}

    def on_gc(phase, info):
        if phase == "start":
            gc_time["t0"] = time.perf_counter()
        else:
            gc_time["s"] += time.perf_counter() - gc_time["t0"]
            gc_time["runs"][info["generation"]] += 1
    torch.cuda.synchronize()
    gc.callbacks.append(on_gc)
    try:
        t0 = time.perf_counter()
        res = engine.sweep(grid, engine="torch", device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    return res, dt, dict(engine.last_sweep_stats, gc_s=gc_time["s"],
                         gc_runs=gc_time["runs"])


def run_sweep(name: str, grid: SW.SweepGrid, want_cells: int,
              log: ShapeLog, want: dict = None, cover: tuple = (),
              engine: SW.SweepEngine = None,
              chip_cover: bool = False) -> dict:
    """One path of the main path: cold run with the launch counters read
    around it, a warm run on the same engine, and the comparison with the
    host columnar path.  ``want`` holds the reference's ``fit`` count and
    int64 ``peak_sum`` (and the sums of the serving columns it names),
    where known; each ``(label, mesh predicate)`` of ``cover`` puts one
    cell whose mesh satisfies it among the six held to ``planner.check``
    (under the grid's profile and each cell's serving knobs), and
    ``chip_cover`` one cell of each chip type (a profile's offset differs
    per chip).  ``engine`` (a fresh one when None) may hold an earlier
    sweep's tables: a grid under another profile must build its own."""
    engine = engine or SW.SweepEngine()
    zero_counts()
    with log:
        cold, cold_s, cold_stats = timed_sweep(engine, grid)
    n_sf, n_sc = SF.launches, SC.launches
    if any(model_counts().values()) or SSD.launches:
        fail(f"{name}: the sweep launched a model kernel")
    warm, warm_s, warm_stats = timed_sweep(engine, grid)
    if len(cold) != want_cells:
        fail(f"{name}: {len(cold)} cells, expected {want_cells}")
    t0 = time.perf_counter()
    host = SW.SweepEngine().sweep(grid, engine="numpy")
    host_s = time.perf_counter() - t0
    for res, tag in ((cold, "cold"), (warm, "warm")):
        for c in RESULT_COLUMNS:
            a, b = getattr(host.columns, c), getattr(res.columns, c)
            if (a is None) != (b is None) or (
                    a is not None and not np.array_equal(a, b)):
                fail(f"{name} ({tag}): column {c} differs from the host "
                     f"columnar path")
    peak = cold.columns.peak_bytes
    if peak.dtype != np.int64 or peak.shape != (want_cells,) \
            or not (peak > 0).all():
        fail(f"{name}: peak_bytes must be positive int64 of {want_cells}")
    live = grid.assembly == "liveness"
    if n_sf <= 0 or n_sf != cold_stats["table_builds"]:
        fail(f"{name}: the sweep launched the shard_factor kernel {n_sf} "
             f"times for {cold_stats['table_builds']} table builds (one "
             f"launch per build)")
    if live and n_sc <= 0:
        fail(f"{name}: the liveness sweep launched the segmented_cummax "
             f"kernel 0 times")
    if not live and n_sc != 0:
        fail(f"{name}: legacy assembly must not launch segmented_cummax")
    if warm_stats["table_cache_hits"] != warm_stats["groups"]:
        fail(f"{name}: the warm sweep rebuilt its tables")
    fit, peak_sum = int(cold.fit_count), int(peak.sum())
    # the serving provenance columns' sums, where the reference's are known
    serve_sums = {c: int(getattr(cold.columns, c).sum())
                  for c in ("pool_bytes", "draft_bytes", "hit_saved_bytes")
                  if want is not None and c in want}
    got = {"fit": fit, "peak_sum": peak_sum, **serve_sums}
    if want is not None and got != want:
        fail(f"{name}: {got}; the reference's {want}")
    # a few cells against the un-memoized scalar predictor
    rng = np.random.default_rng(SEED)
    picks = []
    for label, pred in cover:
        codes = [c for c, m in enumerate(cold.columns.meshes) if pred(m)]
        pool = np.flatnonzero(np.isin(cold.columns.mesh_c, codes))
        if not len(pool):
            fail(f"{name}: no cell of the grid has {label}")
        picks.append(int(rng.choice(pool)))
    if chip_cover:
        for ci in range(len(cold.columns.chip_names)):
            picks.append(int(rng.choice(
                np.flatnonzero(cold.columns.chip_c == ci))))
    picks += rng.choice(want_cells, size=max(6 - len(picks), 0),
                        replace=False).tolist()
    checked = []
    for i in picks:
        r = cold.columns.result(i)
        checked.append(r.mesh_shape)
        rep = PL.check(
            r.arch, ShapeConfig("cell", r.seq_len, r.global_batch, r.kind),
            r.mesh_shape, backend=r.backend, grad_accum=r.grad_accum,
            remat=r.remat, optimizer=r.optimizer, chip=r.chip,
            microbatches=r.microbatches, schedule=r.schedule,
            offload_opt=r.offload, assembly=grid.assembly,
            profile=grid.profile, serve=r.serve)
        if rep.peak_bytes != r.peak_bytes or rep.fits != r.fits \
                or (rep.prediction.pool_bytes, rep.prediction.draft_bytes,
                    rep.prediction.hit_saved_bytes) \
                != (r.pool_bytes, r.draft_bytes, r.hit_saved_bytes):
            fail(f"{name}: cell {i} peak {r.peak_bytes} != planner.check "
                 f"{rep.peak_bytes}")
    out = {"sweep": name, "cells": want_cells, "assembly": grid.assembly,
           "profile": None if grid.profile is None
           else grid.profile.profile_hash,
           "meshes": len(grid.meshes()), "fit": fit,
           "peak_bytes_sum": peak_sum, "serve_sums": serve_sums,
           "checked_meshes": checked,
           "launches": {"shard_factor": n_sf, "segmented_cummax": n_sc},
           "table_builds": cold_stats["table_builds"],
           "shard_factor_requests": cold_stats["shard_factor_requests"],
           "cold_s": cold_s, "warm_s": warm_s, "host_numpy_s": host_s,
           "cold_cells_per_s": want_cells / cold_s,
           "warm_cells_per_s": want_cells / warm_s,
           "host_numpy_cells_per_s": want_cells / host_s,
           "cold_split": cold_stats, "warm_split": warm_stats}
    say("sweep " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 4e-4g: calibration, the calibrated sweeps, the serving fleet
# ---------------------------------------------------------------------------


def run_calibrate() -> dict:
    """Phase 4e (host): fit a CalibrationProfile under each assembly on the
    measurement fixture, and a residual model over it; their hashes are
    gated to the reference's, and the accuracy table (MAPE by family, raw /
    calibrated / learned) must improve every family.  Host arithmetic: no
    kernel runs.  Returns the fitted profiles by assembly."""
    store = MeasurementStore.load(CALIBRATION_FIXTURE)
    engine = SW.SweepEngine()
    profiles = {}
    zero_counts()
    for asm, (want_p, want_r) in CALIBRATION_WANT.items():
        t0 = time.perf_counter()
        prof = CF.fit_profile(store, engine=engine, assembly=asm)
        t1 = time.perf_counter()
        res = CL.fit_residual(store, profile=prof, engine=engine,
                              assembly=asm)
        t2 = time.perf_counter()
        rep = CR.evaluate(store, prof, by="family", engine=engine,
                          assembly=asm, residual=res)
        got = (prof.profile_hash, res.model_hash)
        say("calibrate " + json.dumps({
            "assembly": asm, "measurements": len(store),
            "profile_hash": got[0], "model_hash": got[1],
            "coefficients": prof.coefficients,
            "chip_constant_bytes": prof.chip_constant_bytes,
            "mape_by_family_pct": {r.group: [r.mape_raw, r.mape_calibrated,
                                             r.mape_learned]
                                   for r in rep.rows},
            "mape_pct": [rep.mape_raw, rep.mape_calibrated,
                         rep.mape_learned],
            "fit_s": t1 - t0, "residual_fit_s": t2 - t1,
            "evaluate_s": time.perf_counter() - t2}))
        if got != (want_p, want_r):
            fail(f"calibrate {asm}: profile / residual hashes {got}; the "
                 f"reference's {(want_p, want_r)}")
        if not rep.all_groups_improved \
                or not rep.mape_learned <= rep.mape_calibrated \
                < rep.mape_raw:
            fail(f"calibrate {asm}: the calibrated MAPE does not improve "
                 f"every family")
        profiles[asm] = prof
    if any(model_counts().values()) or SSD.launches or SF.launches \
            or SC.launches:
        fail("calibrate: the host fit launched a kernel")
    return profiles


def run_calibrated(name: str, grid: SW.SweepGrid, want_cells: int,
                   log: ShapeLog, want: dict, golden_want: dict) -> list:
    """A calibrated sweep (``run_sweep`` under the grid's fitted profile),
    then the same engine, warm, under the goldens' profile: a new profile
    is a new table build (no cache hit), each chip's slice gets that
    profile's offset, and the answer is the reference's."""
    engine = SW.SweepEngine()
    first = run_sweep(name, grid, want_cells, log, want=want,
                      engine=engine, chip_cover=True)
    golden = dataclasses.replace(grid, profile=GOLDEN_PROFILE)
    second = run_sweep(f"{name}_then_golden", golden, want_cells, log,
                       want=golden_want, engine=engine, chip_cover=True)
    if second["cold_split"]["table_cache_hits"] != 0:
        fail(f"{name}: the warm engine served the golden profile from the "
             f"fitted profile's tables")
    return [first, second]


# ---------------------------------------------------------------------------
# phase 4d: the planner's search queries
# ---------------------------------------------------------------------------


class CountingEngine(SW.SweepEngine):
    """A sweep engine that sums the table builds of the torch-engine
    sweeps it runs (a pruned search runs one sweep per slice), and those
    of them that asked for a shard denominator other than 1 — each of
    which is one ``shard_factor`` launch."""

    def __init__(self):
        super().__init__()
        self.table_builds = self.sf_batches = self.sweeps = 0

    def sweep(self, grid, *args, engine="torch", **kw):
        res = super().sweep(grid, *args, engine=engine, **kw)
        if engine == "torch":
            self.table_builds += self.last_sweep_stats["table_builds"]
            self.sf_batches += self.last_sweep_stats["shard_factor_batches"]
            self.sweeps += 1
        return res


# the queries and the reference's answers (the JAX package's planner on
# its numpy engine, pruned and exhaustive agreeing): chip count, mesh,
# microbatches, schedule, peak bytes; cells evaluated / pruned
SEARCH_MIN_CHIPS = {
    "deepseek-v2-lite-16b": (
        dict(chips=(8, 16, 32, 64, 128, 256)),
        (8, {"data": 1, "model": 4, "expert": 1, "context": 1, "pipe": 2},
         8, "1f1b", 58394783744), (210, 5136)),
    "arctic-480b": (
        dict(chips=(64, 128, 256, 512), max_ep=128),
        (64, {"data": 32, "model": 1, "expert": 1, "context": 1, "pipe": 2},
         8, "1f1b", 68127506308), (1080, 6468)),
}
SEARCH_FRONTIER = ("seamless-m4t-large-v2", dict(chips=(1, 2, 4, 8, 16)),
                   [(1, 8), (2, 128), (4, 256), (8, 256), (16, 256)])
# (arch, context length) -> (max concurrent sequences, peak bytes there)
SEARCH_CONCURRENCY = {("zamba2-2.7b", 524288): (1, 58949008004),
                      ("minicpm3-4b", 32768): (44, 78942319664)}
# minicpm3-4b at 50 QPS x 10 s of 32,768-token contexts: in flight, per
# replica, replicas
SEARCH_FLEET = (500, 44, 12)
ARCTIC_ADAM_BYTES = 5722203303936
# phase 4h: arctic-480b's smallest pod under the fitted legacy profile.
# The statics floor is off under a profile (a fitted coefficient below 1
# could scale bytes under it), so every count up to the answer is swept:
# cells evaluated / pruned 2,184 / 1,560, where the raw search evaluates
# 1,776 and prunes 1,968 (the 16-chip count by the floor)
SEARCH_CAL_MIN_CHIPS = (
    "arctic-480b", dict(chips=(16, 32, 64, 128), max_ep=128),
    (64, {"data": 64, "model": 1, "expert": 1, "context": 1, "pipe": 1},
     1, "1f1b", 62216530853), (2184, 1560), (1776, 1968))
# llama3.2-3b's concurrency at 8,192-token contexts on one h100 under
# paged serving with a request mix and a draft: max concurrent sequences,
# peak bytes there, probes; 52 sequences without the mix
SEARCH_MIX_SERVE = dict(block_size=16, utilization=0.9, prefix_hit_rate=0.5,
                        prefix_len=1024, draft_arch="smollm-360m")
SEARCH_MIX = ("llama3.2-3b", 8192, "0.25:2048x1,8192x3", (74, 78576519336),
              52)


def timed_ms(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def card_launches(name: str, engine: CountingEngine) -> dict:
    """The sweep kernels' launches since the counters were zeroed: one
    ``shard_factor`` launch per table build that asked for a denominator
    (a slice whose meshes shard nothing asks for none), no
    ``segmented_cummax`` (the searches' grids take the legacy assembly),
    no model kernel."""
    if any(model_counts().values()) or SSD.launches:
        fail(f"{name}: the search launched a model kernel")
    if SF.launches != engine.sf_batches or SC.launches:
        fail(f"{name}: {SF.launches} shard_factor / {SC.launches} "
             f"segmented_cummax launches for {engine.table_builds} table "
             f"builds, {engine.sf_batches} of them with requests (one "
             f"shard_factor launch per such build, legacy assembly)")
    return {"shard_factor": SF.launches, "segmented_cummax": SC.launches}


def say_search(out: dict) -> dict:
    say("search " + json.dumps(out))
    return out


def search_min_chips(arch: str) -> dict:
    q, want, work = SEARCH_MIN_CHIPS[arch]
    kw = dict(chip="h100", allow_ep=True, allow_cp=True, **q)
    engine, stats = CountingEngine(), SR.SearchStats()
    zero_counts()
    got, card_ms = timed_ms(lambda: PL.plan_min_chips(
        arch, "train_4k", engine=engine, stats=stats, **kw))
    launches = card_launches(f"plan_min_chips {arch}", engine)
    host, host_ms = timed_ms(lambda: PL.plan_min_chips(
        arch, "train_4k", search="exhaustive", compute_engine="numpy", **kw))
    grid = PL._search_grid(arch, PL._resolve_shape("train_4k"), q["chips"],
                           "h100", FULL_TRAIN, "tpu", PL.HEADROOM, True, 8,
                           True, q.get("max_ep", 8), True, 8, (1, 4, 8),
                           ("1f1b", "gpipe"), None)
    try:
        SR._assert_same_cell(got, host, f"{arch} card vs host exhaustive")
        oracle = SR.min_chips_search(grid, engine=SW.SweepEngine(),
                                     oracle=True)
        SR._assert_same_cell(oracle, got, f"{arch} oracle")
    except AssertionError as e:
        fail(f"plan_min_chips {arch}: {e}")
    answer = (got.n_chips, got.mesh_shape, got.microbatches, got.schedule,
              got.peak_bytes)
    if answer != want or (stats.cells_evaluated, stats.cells_pruned) != work:
        fail(f"plan_min_chips {arch}: {answer}, {stats.cells_evaluated} / "
             f"{stats.cells_pruned} cells; the reference's {want}, {work}")
    return say_search({
        "query": f"plan_min_chips {arch} train_4k h100 ep cp",
        "answer": {"n_chips": got.n_chips, "mesh": got.mesh_shape,
                   "microbatches": got.microbatches,
                   "schedule": got.schedule, "peak_bytes": got.peak_bytes},
        "cells_evaluated": stats.cells_evaluated,
        "cells_pruned": stats.cells_pruned, "slices": engine.sweeps,
        "launches": launches, "table_builds": engine.table_builds,
        "table_builds_with_requests": engine.sf_batches,
        "oracle": "pruned == exhaustive on the card",
        "pruned_card_ms": card_ms, "exhaustive_host_ms": host_ms})


def search_frontier() -> dict:
    arch, q, want = SEARCH_FRONTIER
    kw = dict(chip="h100", allow_cp=True, **q)
    engine, stats = CountingEngine(), SR.SearchStats()
    zero_counts()
    got, card_ms = timed_ms(lambda: PL.plan_frontier(
        arch, "train_4k", engine=engine, stats=stats, **kw))
    launches = card_launches(f"plan_frontier {arch}", engine)
    host, host_ms = timed_ms(lambda: PL.plan_frontier(
        arch, "train_4k", search="exhaustive", compute_engine="numpy", **kw))
    if not got == host == want:
        fail(f"plan_frontier {arch}: card {got}, host exhaustive {host}, "
             f"the reference's {want}")
    return say_search({
        "query": f"plan_frontier {arch} train_4k h100 cp",
        "answer": got, "cells_evaluated": stats.cells_evaluated,
        "cells_pruned": stats.cells_pruned, "slices": engine.sweeps,
        "launches": launches, "table_builds": engine.table_builds,
        "table_builds_with_requests": engine.sf_batches,
        "pruned_card_ms": card_ms, "exhaustive_host_ms": host_ms})


def search_concurrency(arch: str, seq: int) -> dict:
    """The aligned-ladder search probes the memoized scalar path (host
    arithmetic, no kernel); its exhaustive twin sweeps every concurrency
    1..cap on the mesh, on the card and on the host."""
    want = SEARCH_CONCURRENCY[(arch, seq)]
    stats = SR.SearchStats()
    zero_counts()
    rep, pruned_ms = timed_ms(lambda: PL.plan_max_concurrency(
        arch, seq, chip="h100", kind="decode", stats=stats))
    card_launches(f"plan_max_concurrency {arch}", CountingEngine())
    cap = 65536
    grid = SW.SweepGrid(arch=arch, mesh_shapes=[rep.mesh_shape],
                        kind="decode", chip="h100",
                        global_batches=tuple(range(1, cap + 1)),
                        grad_accums=(1,), seq_lens=(seq,))
    engine = CountingEngine()
    zero_counts()
    card, card_ms = timed_ms(
        lambda: engine.sweep(grid, engine="torch").max_global_batch())
    launches = card_launches(f"exhaustive concurrency {arch}", engine)
    host, host_ms = timed_ms(lambda: SW.SweepEngine().sweep(
        grid, engine="numpy").max_global_batch())
    got = (rep.max_concurrency, rep.peak_bytes)
    for tag, r in (("card", card), ("host", host)):
        if (r.global_batch, r.peak_bytes) != got:
            fail(f"plan_max_concurrency {arch}: {got} != the exhaustive "
                 f"{tag} sweep's {(r.global_batch, r.peak_bytes)}")
    if got != want:
        fail(f"plan_max_concurrency {arch}: {got}; the reference's {want}")
    return say_search({
        "query": f"plan_max_concurrency {arch} {seq} h100 decode",
        "answer": {"max_concurrency": rep.max_concurrency,
                   "peak_bytes": rep.peak_bytes,
                   "budget_bytes": rep.budget_bytes},
        "probes": stats.probes, "exhaustive_cells": cap,
        "launches": launches, "table_builds": engine.table_builds,
        "table_builds_with_requests": engine.sf_batches,
        "pruned_host_ms": pruned_ms, "exhaustive_card_ms": card_ms,
        "exhaustive_host_ms": host_ms})


def search_fleet(per_replica: int) -> dict:
    zero_counts()
    fleet, ms = timed_ms(lambda: PL.plan_replicas("minicpm3-4b", 50, 32768,
                                                  chip="h100"))
    card_launches("plan_replicas", CountingEngine())
    got = (fleet.concurrent_requests, fleet.per_replica, fleet.replicas)
    exhaustive = -(-fleet.concurrent_requests // per_replica)
    if got != SEARCH_FLEET or fleet.replicas != exhaustive:
        fail(f"plan_replicas minicpm3-4b: {got}; the reference's "
             f"{SEARCH_FLEET}, {exhaustive} replicas from the exhaustive "
             f"concurrency")
    adam = PL.adam_state_bytes("arctic-480b")
    if adam != ARCTIC_ADAM_BYTES:
        fail(f"adam_state_bytes arctic-480b: {adam}; the reference's "
             f"{ARCTIC_ADAM_BYTES}")
    return say_search({
        "query": "plan_replicas minicpm3-4b 50 QPS 32768 h100; "
                 "adam_state_bytes arctic-480b",
        "answer": {"in_flight": fleet.concurrent_requests,
                   "per_replica": fleet.per_replica,
                   "replicas": fleet.replicas,
                   "total_chips": fleet.total_chips,
                   "arctic_adam_state_bytes": adam},
        "pruned_host_ms": ms})


def search_calibrated_min_chips(profile) -> dict:
    """plan_min_chips under the fitted profile: pruned on the card with the
    floor off (nothing pruned below the answer), equal to the exhaustive
    host search under the same profile and to the reference's."""
    arch, q, want, work, raw_work = SEARCH_CAL_MIN_CHIPS
    kw = dict(chip="h100", allow_ep=True, allow_cp=True, **q)
    engine, stats = CountingEngine(), SR.SearchStats()
    zero_counts()
    got, card_ms = timed_ms(lambda: PL.plan_min_chips(
        arch, "train_4k", engine=engine, stats=stats, profile=profile,
        **kw))
    launches = card_launches(f"calibrated plan_min_chips {arch}", engine)
    host, host_ms = timed_ms(lambda: PL.plan_min_chips(
        arch, "train_4k", search="exhaustive", compute_engine="numpy",
        profile=profile, **kw))
    raw = SR.SearchStats()
    PL.plan_min_chips(arch, "train_4k", compute_engine="numpy", stats=raw,
                      **kw)
    try:
        SR._assert_same_cell(got, host, f"{arch} card vs host exhaustive")
    except AssertionError as e:
        fail(f"calibrated plan_min_chips {arch}: {e}")
    answer = (got.n_chips, got.mesh_shape, got.microbatches, got.schedule,
              got.peak_bytes)
    counts = (stats.cells_evaluated, stats.cells_pruned)
    raw_counts = (raw.cells_evaluated, raw.cells_pruned)
    out = say_search({
        "query": f"plan_min_chips {arch} train_4k h100 ep cp, profile "
                 f"{profile.profile_hash}",
        "answer": {"n_chips": got.n_chips, "mesh": got.mesh_shape,
                   "microbatches": got.microbatches,
                   "schedule": got.schedule, "peak_bytes": got.peak_bytes},
        "cells_evaluated": counts[0], "cells_pruned": counts[1],
        "raw_cells_evaluated": raw_counts[0],
        "raw_cells_pruned": raw_counts[1], "slices": engine.sweeps,
        "launches": launches, "table_builds": engine.table_builds,
        "table_builds_with_requests": engine.sf_batches,
        "pruned_card_ms": card_ms, "exhaustive_host_ms": host_ms})
    if (answer, counts, raw_counts) != (want, work, raw_work):
        fail(f"calibrated plan_min_chips {arch}: {answer}, {counts}, raw "
             f"{raw_counts}; the reference's {want}, {work}, {raw_work}")
    return out


def search_concurrency_mix() -> dict:
    """plan_max_concurrency under a request mix and a draft (host probes),
    its exhaustive twin swept on the card and on the host up to 4,096
    sequences, each equal to the reference's answer."""
    arch, seq, mix, want, no_mix = SEARCH_MIX
    serve = ServeSpec.make(mix=parse_mix(mix), **SEARCH_MIX_SERVE)
    stats = SR.SearchStats()
    zero_counts()
    rep, pruned_ms = timed_ms(lambda: PL.plan_max_concurrency(
        arch, seq, chip="h100", kind="decode", serve=serve, stats=stats))
    card_launches(f"plan_max_concurrency {arch} mix", CountingEngine())
    plain = PL.plan_max_concurrency(
        arch, seq, chip="h100", kind="decode",
        serve=ServeSpec.make(**SEARCH_MIX_SERVE)).max_concurrency
    cap = 4096
    grid = SW.SweepGrid(
        arch=arch, mesh_shapes=[rep.mesh_shape], kind="decode", chip="h100",
        global_batches=tuple(range(1, cap + 1)), grad_accums=(1,),
        seq_lens=(seq,), block_sizes=(serve.block_size,),
        utilizations=(serve.util_bp / 10000,),
        prefix_hit_rates=(serve.hit_bp / 10000,),
        prefix_len=serve.prefix_len, mixes=(serve.mix,),
        draft_archs=(serve.draft_arch,))
    engine = CountingEngine()
    zero_counts()
    card, card_ms = timed_ms(
        lambda: engine.sweep(grid, engine="torch").max_global_batch())
    launches = card_launches(f"exhaustive concurrency {arch} mix", engine)
    host, host_ms = timed_ms(lambda: SW.SweepEngine().sweep(
        grid, engine="numpy").max_global_batch())
    got = (rep.max_concurrency, rep.peak_bytes)
    out = say_search({
        "query": f"plan_max_concurrency {arch} {seq} h100 decode, mix "
                 f"{mix}, paged, draft {serve.draft_arch}",
        "answer": {"max_concurrency": rep.max_concurrency,
                   "peak_bytes": rep.peak_bytes,
                   "budget_bytes": rep.budget_bytes,
                   "without_mix": plain},
        "probes": stats.probes, "exhaustive_cells": cap,
        "launches": launches, "table_builds": engine.table_builds,
        "table_builds_with_requests": engine.sf_batches,
        "pruned_host_ms": pruned_ms, "exhaustive_card_ms": card_ms,
        "exhaustive_host_ms": host_ms})
    for tag, r in (("card", card), ("host", host)):
        if (r.global_batch, r.peak_bytes) != got:
            fail(f"plan_max_concurrency {arch} mix: {got} != the "
                 f"exhaustive {tag} sweep's {(r.global_batch, r.peak_bytes)}")
    if (got, plain) != (want, no_mix):
        fail(f"plan_max_concurrency {arch} mix: {got}, {plain} without the "
             f"mix; the reference's {want}, {no_mix}")
    return out


def run_calibrated_searches(profile) -> dict:
    """Phase 4h: the searches this slice opens, under the fitted profile
    and under a request mix; launches as in phase 4d."""
    outs = [search_calibrated_min_chips(profile), search_concurrency_mix()]
    return {k: sum(o.get("launches", {}).get(k, 0) for o in outs)
            for k in ("shard_factor", "segmented_cummax")}


def run_searches() -> dict:
    """Phase 4d: each query once; the sweep kernels' launches of the runs
    gated to one shard_factor launch per table build."""
    outs = [search_min_chips(a) for a in SEARCH_MIN_CHIPS]
    outs.append(search_frontier())
    conc = {arch: search_concurrency(arch, seq)
            for arch, seq in SEARCH_CONCURRENCY}
    outs += list(conc.values())
    outs.append(search_fleet(
        conc["minicpm3-4b"]["answer"]["max_concurrency"]))
    return {k: sum(o.get("launches", {}).get(k, 0) for o in outs)
            for k in ("shard_factor", "segmented_cummax")}


# ---------------------------------------------------------------------------
# phase 5: serving llava15-7b
# ---------------------------------------------------------------------------


def serve_counts() -> dict:
    return {"flash_fwd": FL.launches, "rmsnorm_fwd": RN.launches}


class PlainKernels:
    """Within the context the model path takes the kernels' plain versions
    on the card, forward and backward (the kernel path's end-to-end
    cross-check)."""

    def __enter__(self):
        self._saved = (FL.flash_fwd, FL.flash_bwd, RN.rmsnorm_fwd,
                       RN.rmsnorm_bwd, SSD.ssd_scan)
        FL.flash_fwd, FL.flash_bwd = FL.flash_fwd_plain, FL.flash_bwd_plain
        RN.rmsnorm_fwd, RN.rmsnorm_bwd = RN.rmsnorm_fwd_plain, \
            RN.rmsnorm_bwd_plain
        SSD.ssd_scan = SSD.ssd_scan_plain
        return self

    def __exit__(self, *exc):
        (FL.flash_fwd, FL.flash_bwd, RN.rmsnorm_fwd,
         RN.rmsnorm_bwd, SSD.ssd_scan) = self._saved


def vlm_batch(cfg, gen: torch.Generator, n_batch: int, n_text: int) -> dict:
    v = cfg.vlm
    n_patch = (v.vit_image_size // v.vit_patch) ** 2
    patches = torch.randn(n_batch, n_patch, 3 * v.vit_patch ** 2,
                          generator=gen, device=gen.device) * 0.3
    tokens = torch.randint(0, cfg.vocab, (n_batch, n_text), generator=gen,
                           device=gen.device, dtype=torch.int32)
    return {"patches": patches.to(torch.bfloat16), "tokens": tokens}


def logits_agree(got, want, what: str, problems: list = None,
                 tol: float = 2e-2) -> dict:
    """The serving tests' tolerance: |got - want| <= tol * max(1,
    max|want|) (tol 2e-2 but for an MoE's card-vs-CPU runs), and the same
    greedy token wherever want's top-2 margin exceeds twice that.  A miss
    fails the run at once, or with ``problems`` is added to it (the caller
    fails after its line)."""
    got, want = got.float(), want.float()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * tol * scale
    same = got.argmax(-1) == want.argmax(-1)
    miss = None
    if not bool(torch.isfinite(got).all()):
        miss = f"{what}: non-finite logits"
    elif err > tol * scale or not bool(same[clear].all()):
        miss = (f"{what}: max abs diff {err} against tolerance "
                f"{tol * scale}, greedy tokens equal where clear: "
                f"{bool(same[clear].all())}")
    if miss and problems is None:
        fail(miss)
    if miss:
        problems.append(miss)
    return {"max_abs_err": err, "scale": scale,
            "clear_tokens": int(clear.sum()),
            "same_tokens": int(same.sum()), "tokens": int(same.numel())}


def reduced_card_vs_cpu(arch: str, make_batch, counts,
                        tol: float = 2e-2) -> dict:
    """The reduced ``arch``, same weights and batch (``make_batch(cfg,
    generator)`` on the CPU), on the card (kernels) and on the CPU (plain
    versions): prefill + 4 decode steps, the logits within ``tol`` of
    their scale; ``counts()`` the kernels the card run must launch; the
    share of routing choices that differ (an MoE config), a reading."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    cpu_params = model.init(gen, "cpu")
    cpu_batch = make_batch(cfg, gen)
    card_params = copy.deepcopy(cpu_params).to(DEV)
    card_batch = {k: v.to(DEV) for k, v in cpu_batch.items()}
    prefill, decode = SV.make_prefill_step(model), SV.make_decode_step(model)
    routes = {"cpu": RouteLog(), "card": RouteLog()}
    for log in routes.values():
        log.top_i = []

    def routed(side, fn, *args):
        """fn(*args), its routings added to ``side``'s log."""
        with RouteLog() as log:
            res = fn(*args)
        routes[side].top_i += log.top_i
        return res
    before = counts()
    out = {}
    lc, cc = routed("cpu", prefill, cpu_params, cpu_batch)
    lg, cg = routed("card", prefill, card_params, card_batch)
    out["prefill"] = logits_agree(lg.cpu(), lc,
                                  f"reduced {arch} prefill card/cpu", tol=tol)
    cc, cg = SV.pad_cache(cc, 4), SV.pad_cache(cg, 4)
    tok = lc[:, -1].argmax(-1)[:, None].to(torch.int32)
    for i in range(4):
        tok_next, lc, cc = routed("cpu", decode, cpu_params, tok, cc)
        _, lg, cg = routed("card", decode, card_params, tok.to(DEV), cg)
        out[f"decode_{i}"] = logits_agree(lg.cpu(), lc,
                                          f"reduced {arch} decode {i} "
                                          f"card/cpu", tol=tol)
        tok = tok_next
    used = {k: counts()[k] - before[k] for k in before}
    if min(used.values()) <= 0:
        fail(f"reduced {arch} card run launched no kernel: {used}")
    out["launches"] = used
    if cfg.moe:
        out["routing_flips"] = flipped(routes["card"], routes["cpu"])
    return out


def device_breakdown(fn, wall_ms: float, top: int = 6):
    """Device time of one call of ``fn`` from a profiler trace: the sum of
    the CUDA kernels' own times (one stream, so no overlap), the share of
    ``wall_ms`` (the same work timed without the profiler) the card was
    busy, the hand-written kernels' part and the top kernels.  None when
    the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:       # no device tracing on this machine
        print(f"chip_smoke: profiler unavailable ({e})", file=sys.stderr)
        return None
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            rows.append((us / 1e3, ev.key, ev.count))
    busy = sum(r[0] for r in rows)
    if not busy:
        return None
    rows.sort(reverse=True)
    # by substring of the demangled name: "flash_fwd_kernel<" is the fp32
    # FMA kernel, "flash_fwd_kernel_wgmma" the bf16 tensor-core one
    part = {name.rstrip("<"): sum(r[0] for r in rows if name in r[1])
            for name in ("flash_fwd_kernel_wgmma", "flash_fwd_kernel<",
                         "flash_bwd_dq_kernel_wgmma", "flash_bwd_dq_kernel<",
                         "flash_bwd_dkv_kernel_wgmma", "flash_bwd_dkv_kernel<",
                         "rmsnorm_fwd_kernel", "rmsnorm_bwd_kernel",
                         "ssd_state_kernel_wgmma", "ssd_scan_kernel_wgmma",
                         "ssd_scan_kernel<")}
    part = {k: v for k, v in part.items() if v}
    return {"busy_ms": busy, "wall_ms": wall_ms,
            "busy_share": busy / wall_ms,
            "kernel_ms": part, "kernels": sum(r[2] for r in rows),
            "top": [{"ms": ms, "count": n, "kernel": key[:90]}
                    for ms, key, n in rows[:top]]}


def serve_generate(model, params, batch: dict, n_new: int) -> tuple:
    """The main path, once, through the entry point a user calls, with the
    launch counters set to 0 just before: (tokens, seconds)."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = SV.generate(model, params, batch, n_new)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    n_batch, vocab = next(iter(batch.values())).shape[0], model.cfg.vocab
    if tuple(tokens.shape) != (n_batch, n_new) or \
            tokens.dtype != torch.int32 or tokens.device.type != DEV.type or \
            not bool(((tokens >= 0) & (tokens < vocab)).all()):
        fail(f"{model.cfg.name}: generate returned {tokens.dtype} "
             f"{tuple(tokens.shape)} on {tokens.device}")
    return tokens, generate_s


def serve_by_phase(model, params, batch: dict, tokens, counts,
                   after_prefill) -> dict:
    """The program ``generate`` ran, phase by phase: the prefill and the
    decode loop each timed (host clock around work that ends in a
    synchronize), with its allocator peak and ``counts()`` read after the
    counters were set to 0; the generated tokens equal ``tokens``.
    ``after_prefill(logits, cache)`` checks the prefill's outputs (between
    the two timed phases) and returns its readings.  Then one more decode
    step (the cache has room for it) and one more prefill under the
    profiler."""
    n_batch, n_new = tokens.shape
    prefill, decode = SV.make_prefill_step(model), SV.make_decode_step(model)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    prefill_launches = counts()
    if tuple(logits.shape) != (n_batch, 1, model.cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{model.cfg.name}: prefill logits {tuple(logits.shape)} not "
             f"finite / shaped")
    checked = after_prefill(logits, cache)

    cache = SV.pad_cache(cache, n_new)
    with torch.inference_mode():
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    out_tokens = [tok]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(n_new - 1):
        tok, step_logits, cache = decode(params, tok, cache)
        out_tokens.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_peak = torch.cuda.max_memory_allocated()
    decode_launches = counts()
    if not bool(torch.isfinite(step_logits).all()):
        fail(f"{model.cfg.name}: decode logits not finite")
    if not torch.equal(torch.cat(out_tokens, dim=1), tokens):
        fail(f"{model.cfg.name}: the phase-by-phase run generated other "
             f"tokens than generate")

    # where the device time goes
    n_steps = n_new - 1
    on_device = {
        "decode_step": device_breakdown(
            lambda: decode(params, tok, cache), decode_s * 1e3 / n_steps),
        "prefill": device_breakdown(lambda: prefill(params, batch),
                                    prefill_s * 1e3)}
    del cache, logits, step_logits
    return {"prefill_s": prefill_s, "decode_s": decode_s,
            "n_steps": n_steps, "resident_bytes": resident,
            "peaks": {"prefill": prefill_peak, "decode": decode_peak},
            "launches": {"prefill": prefill_launches,
                         "decode": decode_launches},
            "checked": checked, "on_device": on_device}


def check_launches(name: str, phases: dict, main: dict, want: dict) -> None:
    """Launches per phase, and of ``generate`` (their sum), exactly the
    reference's program."""
    if phases["launches"] != want:
        fail(f"{name} launches {phases['launches']} != the reference's "
             f"program {want}")
    want_main = {k: want["prefill"][k] + want["decode"][k]
                 for k in want["prefill"]}
    if main != want_main:
        fail(f"{name}: generate launched {main}, expected {want_main}")


def serve_readings(n_batch: int, n_new: int, generate_s: float, main: dict,
                   phases: dict, preds: dict) -> dict:
    """The common part of a serving phase's line."""
    n_steps = phases["n_steps"]
    peaks = phases["peaks"]
    return {
        "generate_s": generate_s,
        "tokens_per_s": n_batch * n_new / generate_s,
        "prefill_ms": phases["prefill_s"] * 1e3,
        "decode_ms_per_step": phases["decode_s"] * 1e3 / n_steps,
        "decode_tokens_per_s": n_batch * n_steps / phases["decode_s"],
        "launches": {"generate": main,
                     "prefill": phases["launches"]["prefill"],
                     "decode_per_step": {
                         k: v / n_steps for k, v in
                         phases["launches"]["decode"].items()}},
        "resident_bytes": phases["resident_bytes"],
        "measured_peak_bytes": peaks,
        "predicted": preds,
        "measured_over_predicted": {
            k: peaks[k] / preds[k]["peak_bytes"] for k in preds},
        "on_device": phases["on_device"]}


def serve_llava15_7b() -> dict:
    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    torch.cuda.synchronize()
    at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(gen, DEV)
    batch = vlm_batch(cfg, gen, SERVE_BATCH, SERVE_TEXT)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_img = (cfg.vlm.vit_image_size // cfg.vlm.vit_patch) ** 2
    S = n_img + SERVE_TEXT

    tokens, generate_s = serve_generate(model, params, batch, SERVE_NEW)
    main_launches = serve_counts()
    if SF.launches or SC.launches:
        fail("serving launched a sweep kernel")
    if FL.dq_launches or FL.dkv_launches or RN.bwd_launches:
        fail("serving launched a backward kernel")
    if SSD.launches:
        fail("llava15-7b serving launched the SSD kernel")
    for name, n in main_launches.items():
        if n <= 0:
            fail(f"serving launched the {name} kernel 0 times")

    def after_prefill(logits, cache):
        kv_shape = (cfg.n_layers, SERVE_BATCH, S, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
        if tuple(cache["blocks"]["k"].shape) != kv_shape or \
                not bool((cache["len"] == S).all()):
            fail(f"prefill cache {tuple(cache['blocks']['k'].shape)} != "
                 f"{kv_shape}")
        # the kernel path against the same prefill through the plain
        # versions (the gate)
        with PlainKernels():
            plain_logits, _ = SV.make_prefill_step(model)(params, batch)
        checked = logits_agree(logits[:, -1], plain_logits[:, -1],
                               "prefill kernel path vs plain path", problems)
        # a reading: each bf16 path against the same prefill in fp32 (the
        # weights cast, the plain versions), max |diff| over max(1,
        # max |fp32 logits|)
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        params32 = copy.deepcopy(params).float()   # Module.float() casts
        with PlainKernels():                        # in place
            ref, _ = SV.make_prefill_step(model32)(params32, batch)
        checked["vs_fp32_plain"] = {
            "kernels": _rel(logits[:, -1], ref[:, -1]),
            "plain": _rel(plain_logits[:, -1], ref[:, -1])}
        del model32, params32, ref, plain_logits
        gc.collect()
        torch.cuda.empty_cache()
        return checked
    problems = []
    phases = serve_by_phase(model, params, batch, tokens, serve_counts,
                            after_prefill)

    # the reference's program: 24 ViT + 32 LM flash calls in the prefill;
    # RMSNorm 3 per block (norm1 twice: _prefill_kv and the block) + final,
    # and 2 per block + final in each decode step
    n_steps = phases["n_steps"]
    check_launches("serving", phases, main_launches, {
        "prefill": {"flash_fwd": cfg.vlm.vit_layers + cfg.n_layers,
                    "rmsnorm_fwd": 3 * cfg.n_layers + 1},
        "decode": {"flash_fwd": 0,
                   "rmsnorm_fwd": n_steps * (2 * cfg.n_layers + 1)}})

    # the port's own predictor for the same request (XLA byte model,
    # backend="tpu", as examples/serve_batched.py builds it)
    preds = {}
    for kind, seq in (("prefill", S), ("decode", S + SERVE_NEW)):
        p = PR.predict(model, FULL_TRAIN, FA.PredictContext(
            mesh_shape={}, kind=kind, global_batch=SERVE_BATCH,
            seq_len=seq, max_len=seq, backend="tpu"))
        preds[kind] = {"peak_bytes": p.peak_bytes,
                       "param_bytes": p.param_bytes,
                       "cache_bytes": p.cache_bytes,
                       "act_transient_bytes": p.act_transient_bytes,
                       "input_bytes": p.input_bytes}
    out = {
        "arch": SERVE_ARCH, "requests": SERVE_BATCH,
        "prompt_tokens": S, "image_tokens": n_img, "text_tokens": SERVE_TEXT,
        "new_tokens": SERVE_NEW, "params": sum(
            t.numel() for t in params.parameters()),
        "init_s": init_s, "resident_at_start_bytes": at_start,
        **serve_readings(SERVE_BATCH, SERVE_NEW, generate_s, main_launches,
                         phases, preds),
        "prefill_vs_plain": phases["checked"],
    }
    del params, batch, phases
    gc.collect()
    torch.cuda.empty_cache()
    out["reduced_card_vs_cpu"] = reduced_card_vs_cpu(
        SERVE_ARCH, lambda cfg, gen: vlm_batch(cfg, gen, 2, 8), serve_counts)
    say("serve_llava15_7b " + json.dumps(out))
    if problems:
        fail("; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 5b: serving mamba2-1.3b
# ---------------------------------------------------------------------------


def mamba_counts() -> dict:
    return {"ssd_scan": SSD.launches, "rmsnorm_fwd": RN.launches}


def _rel(got, want) -> float:
    """max |got - want| over max(1, max |want|): the serving tests' scale."""
    got, want = got.float(), want.float().to(got.device)
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def mamba_prefill_paths(cfg, params, batch) -> dict:
    """The full-size prefill through the kernels and through the plain
    versions on the same weights and tokens — in bf16 (the served
    program) and in fp32 (the weights cast) — as each path's
    last-position logits and final ssm states, and every pair's distance
    over the compared tensor's scale (mamba2's and the hybrid's); the bf16
    pair by the serving tests' 2e-2 of scale (``logits_agree``) a
    reading."""
    runs = {}

    def run(tag, model, p):
        logits, cache = SV.make_prefill_step(model)(p, batch)
        runs[tag] = (logits[:, -1].float(), cache["blocks"]["ssm"])
        del logits, cache

    model = build_model(cfg)
    zero_counts()
    run("bf16_kernels", model, params)
    if SSD.launches != cfg.n_layers:
        fail(f"the kernel path's prefill launched the SSD kernel "
             f"{SSD.launches} times")
    with PlainKernels():
        run("bf16_plain", model, params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = copy.deepcopy(params).float()
    run("fp32_kernels", model32, params32)
    with PlainKernels():
        run("fp32_plain", model32, params32)
    del params32
    out = {}
    for a, b in (("fp32_kernels", "fp32_plain"),
                 ("bf16_kernels", "bf16_plain"),
                 ("bf16_kernels", "fp32_plain"),
                 ("bf16_plain", "fp32_plain")):
        out[f"{a}_vs_{b}"] = {"logits": _rel(runs[a][0], runs[b][0]),
                              "ssm_state": _rel(runs[a][1], runs[b][1])}
    # greedy tokens, fp32: equal wherever the plain path's top-2 margin
    # exceeds twice the fp32 tolerance of the logits' scale
    want = runs["fp32_plain"][0]
    scale = max(1.0, float(want.abs().max()))
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * MAMBA_FP32_TOL * scale
    same = runs["fp32_kernels"][0].argmax(-1) == want.argmax(-1)
    out["fp32_tokens"] = {"clear": int(clear.sum()),
                          "same_where_clear": int(same[clear].sum()),
                          "same": int(same.sum()), "of": int(same.numel())}
    out["bf16_same_greedy_tokens"] = int(
        (runs["bf16_kernels"][0].argmax(-1)
         == runs["bf16_plain"][0].argmax(-1)).sum())
    out["bf16_kernels_vs_bf16_plain_2e-2"] = logits_agree(
        runs["bf16_kernels"][0], runs["bf16_plain"][0], "", [])
    out["logits_scale"] = float(runs["bf16_plain"][0].abs().max())
    return out


def check_deep_paths(what: str, paths: dict, problems: list) -> None:
    """The gates on ``mamba_prefill_paths`` / ``mla_prefill_paths``: in
    fp32 the kernel path equals the plain path within MAMBA_FP32_TOL of
    the logits' and the states' (or caches') scale, with the same greedy
    tokens where the margin is clear.  In bf16 the two paths differ by the
    rounding spread of many random layers (PERF.md § 6), so the bf16
    kernel path is held to no more than MAMBA_BF16_RATIO times the bf16
    plain path's distance from the fp32 plain path, on each compared
    tensor; a miss goes to ``problems`` (the caller fails after its line
    prints)."""
    f = paths["fp32_kernels_vs_fp32_plain"]
    if max(f.values()) > MAMBA_FP32_TOL:
        fail(f"{what} fp32 prefill, kernel path vs plain path: {f} of "
             f"scale (tolerance {MAMBA_FP32_TOL})")
    t = paths["fp32_tokens"]
    if t["same_where_clear"] != t["clear"]:
        fail(f"{what} fp32 prefill: greedy tokens differ where clear: {t}")
    got = paths["bf16_kernels_vs_fp32_plain"]
    plain = paths["bf16_plain_vs_fp32_plain"]
    for key in got:
        if got[key] > MAMBA_BF16_RATIO * plain[key]:
            problems.append(
                f"{what} bf16 prefill {key}: the kernel path is {got[key]} "
                f"of scale from the fp32 plain path, more than "
                f"{MAMBA_BF16_RATIO}x the bf16 plain path's {plain[key]}")


def serve_mamba2_1_3b() -> dict:
    """mamba2-1.3b at full width and depth with random weights from a
    seeded generator on the card: 4 requests x 2,000 prompt tokens, 32
    greedy tokens through ``generate``, then the same program phase by
    phase."""
    cfg = get_config(MAMBA_ARCH)
    model = build_model(cfg)
    meta = model.spec.children[1].layers[1].meta
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    torch.cuda.synchronize()
    at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(gen, DEV)
    batch = {"tokens": torch.randint(0, cfg.vocab,
                                     (MAMBA_BATCH, MAMBA_PROMPT),
                                     generator=gen, device=DEV,
                                     dtype=torch.int32)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B_, S = MAMBA_BATCH, MAMBA_PROMPT

    tokens, generate_s = serve_generate(model, params, batch, MAMBA_NEW)
    main_launches = mamba_counts()
    if SF.launches or SC.launches or any(
            v for k, v in model_counts().items() if k != "rmsnorm_fwd"):
        fail(f"mamba2 serving launched another kernel: {model_counts()}")

    def after_prefill(logits, cache):
        H, P, N = meta["n_heads"], meta["head_dim"], meta["d_state"]
        want_shapes = {"ssm": ((cfg.n_layers, B_, H, P, N), torch.float32),
                       "conv": ((cfg.n_layers, B_, meta["d_conv"] - 1,
                                 meta["conv_ch"]), torch.bfloat16)}
        for key, (shape, dtype) in want_shapes.items():
            leaf = cache["blocks"][key]
            if tuple(leaf.shape) != shape or leaf.dtype != dtype or \
                    not bool(torch.isfinite(leaf.float()).all()):
                fail(f"mamba2 prefill cache {key}: {leaf.dtype} "
                     f"{tuple(leaf.shape)}, expected {dtype} {shape}")
        if not bool((cache["len"] == S).all()):
            fail("mamba2 prefill cache len")
        # the kernel path against the same prefill through the plain
        # versions, in bf16 and in fp32
        paths = mamba_prefill_paths(cfg, params, batch)
        check_deep_paths("mamba2", paths, problems)
        return paths
    problems = []
    phases = serve_by_phase(model, params, batch, tokens, mamba_counts,
                            after_prefill)

    # the reference's program: one SSD per layer in the prefill and none
    # in decode; RMSNorm twice per layer (block norm, gated norm) + the
    # final norm in the prefill and in each decode step
    L, n_steps = cfg.n_layers, phases["n_steps"]
    check_launches("mamba2 serving", phases, main_launches, {
        "prefill": {"ssd_scan": L, "rmsnorm_fwd": 2 * L + 1},
        "decode": {"ssd_scan": 0, "rmsnorm_fwd": n_steps * (2 * L + 1)}})

    # the port's own predictor for the same request (planner.check, the
    # XLA byte model, backend="tpu", one device)
    preds = {}
    for kind, seq in (("prefill", S), ("decode", S + MAMBA_NEW)):
        rep = PL.check(MAMBA_ARCH, ShapeConfig("serve", seq, B_, kind), {},
                       backend="tpu", chip="h100")
        p = rep.prediction
        preds[kind] = {"peak_bytes": p.peak_bytes,
                       "param_bytes": p.param_bytes,
                       "cache_bytes": p.cache_bytes,
                       "act_transient_bytes": p.act_transient_bytes,
                       "input_bytes": p.input_bytes,
                       "fits_h100": rep.fits}
    out = {
        "arch": MAMBA_ARCH, "requests": B_, "prompt_tokens": S,
        "new_tokens": MAMBA_NEW, "n_layers": L,
        "params": sum(t.numel() for t in params.parameters()),
        "param_bytes": sum(t.numel() * t.element_size()
                           for t in params.parameters()),
        "init_s": init_s, "resident_at_start_bytes": at_start,
        **serve_readings(B_, MAMBA_NEW, generate_s, main_launches, phases,
                         preds),
        "prefill_tokens_per_s": B_ * S / phases["prefill_s"],
        "prefill_vs_plain": phases["checked"],
    }
    del params, batch, phases
    gc.collect()
    torch.cuda.empty_cache()
    out["reduced_card_vs_cpu"] = reduced_card_vs_cpu(
        MAMBA_ARCH, lambda cfg, gen: {"tokens": torch.randint(
            0, cfg.vocab, (2, 40), generator=gen, dtype=torch.int32)},
        mamba_counts)
    say("serve_mamba2_1_3b " + json.dumps(out))
    if problems:
        fail("; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 6: training llava15-7b
# ---------------------------------------------------------------------------


def train_batch(cfg, gen: torch.Generator, n_batch: int, n_text: int):
    batch = vlm_batch(cfg, gen, n_batch, n_text)
    batch["labels"] = torch.randint(0, cfg.vocab, (n_batch, n_text),
                                    generator=gen, device=gen.device,
                                    dtype=torch.int32)
    return batch


def train_program(cfg) -> dict:
    """The reference's launches per step under remat "block" with a frozen
    vision tower (a decoder LM: no tower): the ViT's 24 attention
    forwards; each LM block's
    attention forward and its two RMSNorms twice (the recompute reruns the
    block in the backward), its attention backward and RMSNorm backwards
    once; the final norm once each way.  The enc-dec under FULL_TRAIN: each
    encoder block's attention and two RMSNorms, each decoder block's self
    and cross attention and three RMSNorms, forward twice and backward
    once; the encoder's and the decoder's final norms once each way.
    mamba2 under FULL_TRAIN: each block's two RMSNorms (block norm, gated
    norm) forward twice and backward once, the final norm once each way;
    no attention, and no SSD kernel (training runs the chunked SSD in
    plain tensor ops).  An MLA block also runs its attention's kv_norm
    (and q_norm with a q rank) forward twice and backward once.  The
    hybrid: each mamba block's two RMSNorms forward twice (the recompute)
    and backward once; each shared-attention invocation, outside the
    remat, its attention and two RMSNorms forward once and backward once;
    the final norm once each way."""
    if cfg.family == "hybrid":
        n, inv = cfg.n_layers, cfg.n_layers // cfg.hybrid.attn_every
        return {"flash_fwd": inv, "flash_dq": inv, "flash_dkv": inv,
                "rmsnorm_fwd": 2 * 2 * n + 2 * inv + 1,
                "rmsnorm_bwd": 2 * n + 2 * inv + 1}
    if cfg.family == "ssm":
        n = cfg.n_layers
        return {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                "rmsnorm_fwd": 2 * 2 * n + 1, "rmsnorm_bwd": 2 * n + 1}
    if cfg.family == "encdec":
        attn = cfg.encdec.n_enc_layers + 2 * cfg.n_layers
        norms = 2 * cfg.encdec.n_enc_layers + 3 * cfg.n_layers
        return {"flash_fwd": 2 * attn, "flash_dq": attn, "flash_dkv": attn,
                "rmsnorm_fwd": 2 * norms + 2, "rmsnorm_bwd": norms + 2}
    n = cfg.n_layers
    vit = cfg.vlm.vit_layers if cfg.vlm else 0
    norms = 2 + (1 + bool(cfg.mla.q_lora_rank) if cfg.mla else 0)
    return {"flash_fwd": vit + 2 * n, "flash_dq": n,
            "flash_dkv": n, "rmsnorm_fwd": 2 * norms * n + 1,
            "rmsnorm_bwd": norms * n + 1}


def checksums_of(tensors: dict) -> dict:
    """name -> the int64 sum of each tensor's bit patterns: a tensor that
    changes almost surely changes it."""
    out = {}
    for name, t in tensors.items():
        bits = t.detach().view(torch.int16 if t.element_size() == 2
                               else torch.int32)
        out[name] = int(bits.sum(dtype=torch.int64))
    return out


def checksums(params) -> dict:
    return checksums_of(dict(params.named_parameters()))


def loss_and_grads(model, params, batch) -> tuple:
    """Loss and the trainable leaves' gradients, no update."""
    named = PM.trainable_params(params)
    loss, _ = model.loss(params, batch, remat="block")
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return float(loss.detach()), dict(zip([n for n, _ in named], grads))


def grads_agree(got: dict, want: dict, tol, what: str,
                problems: list) -> dict:
    """Per tensor max |got - want| / max |want|, on want's device (on the
    card, one tensor at a time, where both were kept on the host); every
    tensor must stay within ``tol`` of its scale (``tol`` None: a
    reading, no gate)."""
    worst, worst_leaf, worst_norm = 0.0, None, 0.0
    for name, w in want.items():
        dev = DEV if w.device.type == got[name].device.type == "cpu" \
            else w.device
        w = w.to(dev).float()
        d = got[name].float().to(dev) - w
        rel = float(d.abs().max()) / max(float(w.abs().max()), 1e-30)
        worst_norm = max(worst_norm, float(d.norm()) /
                         max(float(w.norm()), 1e-30))
        if rel >= worst:
            worst, worst_leaf = rel, name
        if tol is not None and rel > tol:
            problems.append(f"{what}: {name} differs by {rel:.3g} of its "
                            f"scale (tolerance {tol})")
    return {"max_rel_err": worst, "worst_leaf": worst_leaf,
            "max_norm_rel_err": worst_norm, "tolerance": tol}


class RouteLog:
    """Within the context every MoE routing (``models.moe._route``) is
    recorded: each call's top-k expert indices (T, k), on the host."""

    def __enter__(self):
        self.top_i = []
        self._saved = MOE._route

        def route(logits, top_k):
            out = self._saved(logits, top_k)
            self.top_i.append(out[1].cpu())
            return out
        MOE._route = route
        return self

    def __exit__(self, *exc):
        MOE._route = self._saved

    def dropped(self, n_experts: int, top_k: int, cf: float) -> dict:
        """The (token, expert) pairs past their expert's capacity, over
        every routing recorded (each one dispatch of ``_ep_local``)."""
        pairs = drops = 0
        for top_i in self.top_i:
            C = MOE._capacity(top_i.shape[0], top_k, n_experts, cf)
            drops += int((MOE._slots(top_i.reshape(-1), n_experts)
                          >= C).sum())
            pairs += top_i.numel()
        return {"pairs": pairs, "dropped": drops,
                "share": drops / max(pairs, 1)}


class RouteReplay:
    """Within the context every MoE routing takes the top-k experts that
    ``log`` (a RouteLog) recorded, in its order: each path computes its own
    router probabilities and renormalized weights over those experts, so
    two paths compared under one replay differ in their numerics, not in
    their routing."""

    def __init__(self, log: RouteLog):
        self.top_i = list(log.top_i)

    def __enter__(self):
        self._saved = MOE._route
        calls = iter(self.top_i)

        def route(logits, top_k):
            probs = torch.softmax(logits.float(), dim=-1)
            top_i = next(calls).to(probs.device)
            top_p = probs.gather(-1, top_i)
            top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
            return top_p, top_i, probs
        MOE._route = route
        return self

    def __exit__(self, *exc):
        MOE._route = self._saved


def flipped(a: RouteLog, b: RouteLog) -> dict:
    """Tokens whose top-k expert set differs between two runs of the same
    program (their routings in the same order)."""
    if len(a.top_i) != len(b.top_i):
        fail(f"the runs routed {len(a.top_i)} and {len(b.top_i)} times")
    tokens = differ = 0
    for x, y in zip(a.top_i, b.top_i):
        differ += int((x.sort(-1).values != y.sort(-1).values)
                      .any(-1).sum())
        tokens += x.shape[0]
    return {"tokens": tokens, "differ": differ,
            "share": differ / max(tokens, 1)}


def reduced_train_card_vs_cpu(problems: list, arch: str = TRAIN_ARCH,
                              policy=LLAVA_STAGE2, make_batch=None,
                              optimizer: str = "adamw", steps: int = 1,
                              tol: float = 2e-2,
                              params_gate: bool = True) -> dict:
    """The reduced ``arch``, same weights and batch (``make_batch(cfg,
    gen)``, default the VLM's 2 x 8), ``steps`` steps of ``policy`` on the
    card (kernels) and on the CPU (plain versions): the loss and the
    gradients before the first step, every step's loss and the params
    after the last within ``tol`` of each tensor's scale (with
    ``params_gate`` False the params are a reading); the share of routing
    choices that differ (an MoE config), a reading."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    params = {"cpu": model.init(gen, "cpu")}
    batches = {"cpu": (make_batch or (lambda c, g: train_batch(c, g, 2, 8)))(
        cfg, gen)}
    params["card"] = copy.deepcopy(params["cpu"]).to(DEV)
    batches["card"] = {k: v.to(DEV) for k, v in batches["cpu"].items()}
    opt_cfg = OptimizerConfig(name=optimizer)
    step = make_train_step(model, policy, opt_cfg, remat="block")
    before = model_counts()
    res, routes = {}, {}
    for side in ("cpu", "card"):
        st = train_state(params[side], policy, opt_cfg)
        with RouteLog() as routes[side]:
            loss, grads = loss_and_grads(model, st.params, batches[side])
        losses = []
        for _ in range(steps):
            st, metrics = step(st, batches[side])
            losses.append(float(metrics["loss"]))
        res[side] = (loss, grads, dict(st.params.named_parameters()),
                     losses)
    used = {k: model_counts()[k] - before[k] for k in before}
    if min(v for k, v in used.items()
           if train_program(cfg)[k] > 0) <= 0:
        problems.append(f"reduced card training launched a kernel no time: "
                        f"{used}")
    (l_cpu, g_cpu, p_cpu, m_cpu) = res["cpu"]
    (l_card, g_card, p_card, m_card) = res["card"]
    for a, b, what in [(l_card, l_cpu, "loss")] + [
            (x, y, f"step {i} loss") for i, (x, y) in
            enumerate(zip(m_card, m_cpu))]:
        if abs(a - b) > tol * max(1.0, abs(b)):
            problems.append(f"reduced train card/cpu: {what} {a} vs {b}")
    out = {"arch": cfg.name, "optimizer": optimizer, "steps": steps,
           "loss": {"card": l_card, "cpu": l_cpu},
           "step_losses": {"card": m_card, "cpu": m_cpu},
           "grads": grads_agree(g_card, g_cpu, tol,
                                "reduced train card/cpu grads", problems),
           "params": grads_agree({k: v.detach() for k, v in p_card.items()},
                                 {k: v.detach() for k, v in p_cpu.items()},
                                 tol if params_gate else None,
                                 "reduced train card/cpu params",
                                 problems),
           "launches": used}
    if cfg.moe:
        out["routing_flips"] = flipped(routes["card"], routes["cpu"])
    return out


def train_phase(name: str, cfg, policy, cut: str, problems: list,
                make_batch=None, n_batch: int = TRAIN_BATCH,
                seq_len: int = None, fp64_witness: bool = False,
                optimizer: str = "adamw", check_batch: int = None,
                profile: bool = True) -> dict:
    """TRAIN_STEPS steps of ``policy`` under ``optimizer`` through
    ``init_train_state`` / ``make_train_step`` (the entry points a user
    calls) on ``n_batch`` samples of ``seq_len`` tokens
    (``make_batch(cfg, gen)``; by default the VLM's fig2b batch), each
    step's time, launches and allocator peak; the gates (the loss finite
    and moving); with ``profile`` one step under the profiler; the kernel
    path against the
    plain path (with ``fp64_witness`` both fp32 paths against float64,
    :func:`float64_witness`, the gate), on the first ``check_batch``
    samples (default all) with every gradient set but the one being made
    kept on the host; the byte model's prediction for the same config."""
    if make_batch is None:
        seq_len = TRAIN_TEXT + cfg.vlm.n_image_tokens

        def make_batch(cfg, gen):
            return train_batch(cfg, gen, TRAIN_BATCH, TRAIN_TEXT)
    model = build_model(cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    opt_cfg = OptimizerConfig(name=optimizer)
    torch.cuda.synchronize()
    at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = init_train_state(model, policy, opt_cfg, gen, DEV)
    batch = make_batch(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    before = checksums(state.params)
    # each trainable tensor's slice of its leaf's (stacked) fp32 master;
    # an optimizer without one (Adafactor) updates the tensor itself
    has_master = all("master" in state.opt[leaf.name]
                     for leaf in PM.trainable_leaves(state.params))
    masters = {n: (state.opt[leaf.name]["master"][i] if leaf.stacked
                   else state.opt[leaf.name]["master"]) if has_master
               else t for leaf in PM.trainable_leaves(state.params)
               for i, (n, t) in enumerate(leaf.params)}
    masters_before = checksums_of(masters)
    trainable = set(masters)
    step = make_train_step(model, policy, opt_cfg, remat="block")
    want = train_program(cfg)

    steps, split = [], {}
    t_split = time.perf_counter()
    for i in range(TRAIN_STEPS):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        segments = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        zero_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        segments = torch.cuda.memory_stats().get(
            "segment.all.allocated", 0) - segments
        launches = model_counts()
        peak = torch.cuda.max_memory_allocated()
        loss = float(metrics["loss"])
        if not np.isfinite(loss) or not np.isfinite(
                float(metrics["grad_norm"])):
            fail(f"{name}: step {i} loss {loss} / grad_norm not finite")
        if SF.launches or SC.launches or SSD.launches:
            fail(f"{name}: training launched a sweep or the SSD kernel")
        if launches != want:
            fail(f"{name}: step {i} launched {launches}, the reference's "
                 f"program {want}")
        steps.append({"ms": ms, "loss": loss,
                      "grad_norm": float(metrics["grad_norm"]),
                      "peak_bytes": peak, "resident_bytes": resident,
                      "segments_allocated": segments,
                      "launches": launches})
    if int(state.step) != TRAIN_STEPS:
        fail(f"{name}: step count {int(state.step)}")
    if len({s["loss"] for s in steps}) < 2:
        problems.append(f"{name}: the loss did not move: "
                        f"{[s['loss'] for s in steps]}")
    # a trainable leaf moves in its fp32 master copy (the optimizer's
    # parameter); its bf16 copy may round back to the same value, as a
    # norm scale of 1.0 does under steps of ~lr; without a master copy a
    # matrix must move in bf16 and a 1-D leaf (a norm scale) may not (a
    # reading); a frozen leaf is bit-equal in the model
    after = checksums(state.params)
    masters_after = checksums_of(masters)
    still = sorted(n for n in trainable
                   if masters_after[n] == masters_before[n]
                   and (has_master or masters[n].dim() > 1))
    moved = sorted(n for n in before if n not in trainable
                   and after[n] != before[n])
    if still or moved or not trainable:
        problems.append(f"{name}: trainable leaves that did not move "
                        f"{still[:4]}, frozen leaves that moved {moved[:4]}")
    bf16_moved = sum(after[n] != before[n] for n in trainable)

    # where the device time goes: one more step under the profiler
    med_ms = statistics.median(s["ms"] for s in steps)
    split["steps"] = time.perf_counter() - t_split
    on_device = None
    if profile:
        on_device = device_breakdown(lambda: step(state, batch), med_ms,
                                     top=8)
        split["profiled_step"] = time.perf_counter() - t_split - sum(
            split.values())

    # the kernel path against the plain path, same weights and batch (its
    # first check_batch samples; each gradient set but the one being made
    # then waits on the host)
    vs_plain = {}
    if check_batch:
        cbatch = {k: v[:check_batch] for k, v in batch.items()}
        keep = lambda grads: {n: g.cpu() for n, g in grads.items()}
    else:
        cbatch, keep = batch, (lambda grads: grads)
    zero_counts()
    k_loss, k_grads = loss_and_grads(model, state.params, cbatch)
    if model_counts() != want:
        problems.append(f"{name}: loss and grads launched {model_counts()}")
    k_grads = keep(k_grads)
    zero_counts()
    with PlainKernels():
        p_loss, p_grads = loss_and_grads(model, state.params, cbatch)
    if any(model_counts().values()):
        problems.append(f"{name}: the plain path launched a kernel")
    bf16 = {"loss": {"kernels": k_loss, "plain": p_loss},
            "grads": grads_agree(k_grads, p_grads, None, "", [])}
    # the gate: the same in fp32 (the fp32 kernels; bf16 rounding out of
    # the way), on the same weights cast to fp32, every trainable leaf
    # within FP32_GRAD_TOL of its scale (with fp64_witness a reading, the
    # gate the float64 witness's below)
    del state.opt, masters
    gc.collect()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = state.params.float()
    p_grads = keep(p_grads)
    f_loss, f_grads = loss_and_grads(model32, params32, cbatch)
    f_grads = keep(f_grads)
    with PlainKernels():
        fp_loss, fp_grads = loss_and_grads(model32, params32, cbatch)
    vs_plain["fp32"] = {
        "loss": {"kernels": f_loss, "plain": fp_loss},
        "grads": grads_agree(f_grads, fp_grads,
                             None if fp64_witness else FP32_GRAD_TOL,
                             f"{name} fp32 kernel path vs plain path",
                             problems)}
    for what, a, b in (("bf16", k_loss, p_loss), ("fp32", f_loss, fp_loss)):
        if abs(a - b) > 2e-2 * max(1.0, abs(b)):
            problems.append(f"{name}: {what} loss {a} through the kernels, "
                            f"{b} through the plain versions")
    # a reading: each bf16 path's gradients against the fp32 kernel path's
    bf16["vs_fp32"] = {path: grads_agree(grads, f_grads, None, "", [])
                       for path, grads in (("kernels", k_grads),
                                           ("plain", p_grads))}
    vs_plain["bf16"] = bf16
    vs_plain["batch"] = next(iter(cbatch.values())).shape[0]
    del k_grads, p_grads
    split["bf16_and_fp32_checks"] = time.perf_counter() - t_split - sum(
        split.values())
    if fp64_witness:
        fp_grads = keep(fp_grads)
        vs_plain["fp64"] = float64_witness(name, model32, params32, cbatch,
                                           {"kernels": f_grads,
                                            "plain": fp_grads}, problems)
        split["fp64_witness"] = time.perf_counter() - t_split - sum(
            split.values())
    del f_grads, fp_grads, params32

    pred = PR.predict(model, policy, FA.PredictContext(
        kind="train", global_batch=n_batch, seq_len=seq_len, remat="block",
        optimizer=optimizer, backend="tpu",
        enc_seq=int(seq_len * cfg.encdec.enc_seq_ratio) if cfg.encdec
        else 0))
    peak = max(s["peak_bytes"] for s in steps)
    out = {"arch": cfg.name, "cut": cut, "policy": policy.name,
           "n_layers": cfg.n_layers, "batch": n_batch,
           "tokens_per_sample": seq_len,
           **({"image_tokens": cfg.vlm.n_image_tokens,
               "text_tokens": TRAIN_TEXT} if cfg.vlm else
              {"encoder_frames": int(seq_len * cfg.encdec.enc_seq_ratio)}
              if cfg.encdec else {}),
           "params": sum(t.numel() for t in state.params.parameters()),
           "trainable_params": sum(t.numel() for _, t in
                                   PM.trainable_params(state.params)),
           "optimizer": optimizer, "remat": "block", "init_s": init_s,
           "ms_per_step": [s["ms"] for s in steps],
           "loss_per_step": [s["loss"] for s in steps],
           "launches_per_step": steps[-1]["launches"],
           "launches_total": {k: sum(s["launches"][k] for s in steps)
                              for k in want},
           "tokens_per_s": n_batch * seq_len / (med_ms / 1e3),
           "measured_peak_bytes": [s["peak_bytes"] for s in steps],
           # allocator segments (cudaMalloc calls) each step made
           "segments_allocated": [s["segments_allocated"] for s in steps],
           "resident_at_start_bytes": at_start,
           "resident_bytes": steps[0]["resident_bytes"],
           "predicted": {"peak_bytes": pred.peak_bytes,
                         "param_bytes": pred.param_bytes,
                         "grad_bytes": pred.grad_bytes,
                         "opt_bytes": pred.opt_bytes,
                         "act_saved_bytes": pred.act_saved_bytes,
                         "act_transient_bytes": pred.act_transient_bytes},
           "measured_over_predicted": peak / pred.peak_bytes,
           "leaves": {"trainable_moved": len(trainable),
                      "trainable_moved_in_bf16": bf16_moved,
                      "frozen_bit_equal": len(before) - len(trainable)},
           "vs_plain": vs_plain, "on_device": on_device,
           # seconds of the phase's parts (host clock)
           "split_s": split}
    del state, batch, cbatch, model, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _attention64(q, k, v, causal: bool = True, q_offset: int = 0):
    """Attention as plain autograd ops in the inputs' type (float64 for the
    witness): scores, softmax, weighted sum; GQA by grouping."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D) * D ** -0.5
    s = torch.einsum("bshgd,bthd->bhgst", qg, k)
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        keep = torch.arange(Skv, device=q.device)[None, :] <= q_pos[:, None]
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgst,bthd->bshgd", p, v).reshape(B, Sq, H, -1)


def _rmsnorm64(x, scale, eps: float = 1e-5):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


class Float64Plain:
    """Within the context the model path runs in float64 where its weights
    are float64: attention and RMSNorm as plain autograd ops, and a
    ``.float()`` (the model's casts to fp32 around the loss and the rotary
    embedding) keeps a float64 tensor as it is.  The rotary angles stay
    fp32, as in both fp32 paths."""

    def __enter__(self):
        self._saved = (OPS.flash_attention, OPS.rmsnorm, torch.Tensor.float)
        to_float = self._saved[2]

        def float_keeping_64(t, *a, **kw):
            return t if t.dtype == torch.float64 else to_float(t, *a, **kw)
        OPS.flash_attention, OPS.rmsnorm = _attention64, _rmsnorm64
        torch.Tensor.float = float_keeping_64
        return self

    def __exit__(self, *exc):
        OPS.flash_attention, OPS.rmsnorm, torch.Tensor.float = self._saved


def float64_witness(name: str, model32, params32, batch,
                    fp32_grads: dict, problems: list) -> dict:
    """The loss and every trainable leaf's gradient in float64 at the same
    weights (``params32`` is cast in place) and batch, and each fp32
    path's (``fp32_grads``: "kernels", "plain") max |diff| from them over
    the leaf's max |grad| (and the same in norms, a reading).  The gate:
    the kernel path's worst leaf at most FP32_GRAD_TOL or
    FP64_WITNESS_RATIO times the plain path's worst leaf."""
    params64 = params32.double()
    zero_counts()
    with Float64Plain():
        w_loss, w_grads = loss_and_grads(model32, params64, batch)
    if any(model_counts().values()):
        problems.append(f"{name}: the float64 witness launched a kernel")
    dist = {path: {} for path in fp32_grads}
    norm = {path: {} for path in fp32_grads}
    for leaf, w in w_grads.items():
        scale = max(float(w.abs().max()), 1e-300)
        for path, grads in fp32_grads.items():
            d = grads[leaf].to(w.device).double() - w
            dist[path][leaf] = float(d.abs().max()) / scale
            norm[path][leaf] = float(d.norm()) / max(float(w.norm()), 1e-300)
    del w_grads

    def worst(path):
        leaf = max(dist[path], key=dist[path].get)
        return {"max_rel_err": dist[path][leaf], "worst_leaf": leaf,
                "max_norm_rel_err": max(norm[path].values())}
    ek, ep = worst("kernels"), worst("plain")
    if ek["max_rel_err"] > max(FP32_GRAD_TOL,
                               FP64_WITNESS_RATIO * ep["max_rel_err"]):
        problems.append(f"{name}: fp32 kernel path {ek} from float64, the "
                        f"plain path {ep} (at most max({FP32_GRAD_TOL}, "
                        f"{FP64_WITNESS_RATIO} x the plain path's))")
    apart = {leaf: {"kernels": d, "plain": dist["plain"][leaf]}
             for leaf, d in dist["kernels"].items()
             if max(d, dist["plain"][leaf]) > FP32_GRAD_TOL}
    ratios = {what: sorted(r[leaf] / max(r_p[leaf], 1e-300)
                           for leaf in r)
              for what, r, r_p in (("max", dist["kernels"], dist["plain"]),
                                   ("norm", norm["kernels"], norm["plain"]))}
    return {"loss": w_loss, "kernels": ek, "plain": ep,
            # each leaf's kernels / plain distance: min, median, max
            "leaf_ratio_kernels_over_plain": {
                what: [r[0], r[len(r) // 2], r[-1]]
                for what, r in ratios.items()},
            "leaves_over_fp32_tol": len(apart),
            "over_fp32_tol": dict(sorted(
                apart.items(), key=lambda kv: -kv[1]["kernels"])[:12]),
            "ratio": FP64_WITNESS_RATIO, "floor": FP32_GRAD_TOL}


def train_llava15_7b() -> list:
    """Both training phases; each prints its line before its gates can
    fail the run."""
    cfg = get_config(TRAIN_ARCH)
    problems = []
    stage1 = train_phase("train_llava15_7b_stage1", cfg, LLAVA_STAGE1,
                         "none: full width and depth", problems)
    say("train_llava15_7b_stage1 " + json.dumps(stage1))
    spread = stage1["vs_plain"]["bf16"]
    say("train_llava15_7b_stage1_bf16_spread " + json.dumps({
        "kernels_vs_fp32": spread["vs_fp32"]["kernels"],
        "plain_vs_fp32": spread["vs_fp32"]["plain"],
        "kernels_vs_plain": spread["grads"]}))
    if problems:
        fail("; ".join(problems))
    cut = dataclasses.replace(cfg, n_layers=STAGE2_LAYERS)
    stage2 = train_phase("train_llava15_7b_stage2_8l", cut, LLAVA_STAGE2,
                         f"LM depth {STAGE2_LAYERS} of {cfg.n_layers} blocks"
                         f" (full width)", problems)
    # full depth does not fit one card: the planner's verdict, printed
    rep = PL.check(TRAIN_ARCH, ShapeConfig("fig2b", TRAIN_TEXT
                                           + cfg.vlm.n_image_tokens,
                                           TRAIN_BATCH, "train"), {},
                   policy=LLAVA_STAGE2, remat="block", optimizer="adamw",
                   chip="h100")
    stage2["full_depth_plan"] = {"chip": "h100", "fits": rep.fits,
                                 "peak_bytes": rep.peak_bytes,
                                 "budget_bytes": rep.budget_bytes}
    stage2["reduced_card_vs_cpu"] = reduced_train_card_vs_cpu(problems)
    say("train_llava15_7b_stage2_8l " + json.dumps(stage2))
    if problems:
        fail("; ".join(problems))
    return [stage1, stage2]


def byte_model_state(model, policy, opt_cfg) -> dict:
    """The byte model's optimizer-state bytes of each trainable leaf:
    ``core.factors.opt_bytes_for`` of the leaf's stacked shape, on one
    device (no sharding), by the leaf's name."""
    out = {}
    for r in parse_model(model.spec, policy):
        if not r.trainable:
            continue
        for pname, p in r.layer.params.items():
            shape, _ = FA._stacked(p, r)
            out[f"{r.module_path.replace('/', '.')}.{r.layer.name}."
                f"{pname}"] = FA.opt_bytes_for(
                    p, shape, opt_cfg.name, opt_cfg.master_fp32) \
                * (1 if r.scanned else r.repeat)
    return out


def train_optimizers() -> dict:
    """llava15-7b stage 2 at full width with the LM cut to 8 blocks (as
    ``train_llava15_7b_stage2_8l``), one step each of Adafactor and 8-bit
    Adam through ``train_state`` / ``make_train_step``: the state's bytes
    per leaf gated to equal the byte model's ``opt_bytes_for`` exactly
    (the allocator's growth over the state's making a reading), the step
    time, its launches against the reference's program, its peak.  Its
    launches are not the kernels line's (the AdamW phases are)."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=STAGE2_LAYERS)
    model = build_model(cfg)
    want_launches = train_program(cfg)
    out = {"arch": cfg.name, "policy": LLAVA_STAGE2.name,
           "n_layers": cfg.n_layers, "batch": TRAIN_BATCH,
           "tokens_per_sample": TRAIN_TEXT + cfg.vlm.n_image_tokens}
    for name in ("adafactor", "adamw8bit"):
        opt_cfg = OptimizerConfig(name=name)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(SEED)
        params = model.init(gen, DEV)
        batch = train_batch(cfg, gen, TRAIN_BATCH, TRAIN_TEXT)
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_allocated()
        state = train_state(params, LLAVA_STAGE2, opt_cfg)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - a0
        got = TO.state_bytes(state.opt)
        want = byte_model_state(model, LLAVA_STAGE2, opt_cfg)
        step = make_train_step(model, LLAVA_STAGE2, opt_cfg, remat="block")
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = model_counts()
        loss = float(metrics["loss"])
        norms = [n for n in got if n.endswith("norm1.scale")]
        out[name] = {
            "state_bytes": sum(got.values()),
            "byte_model_state_bytes": sum(want.values()),
            "leaves": len(got), "allocator_growth_bytes": grown,
            "stacked_norm_state": {n: {k: list(v.shape) for k, v in
                                       state.opt[n].items()}
                                   for n in norms},
            "step_ms": ms, "loss": loss, "launches": launches,
            "peak_bytes": torch.cuda.max_memory_allocated()}
        say(f"train_llava15_7b_stage2_8l_{name} " + json.dumps(out[name]))
        if got != want:
            bad = sorted(n for n in set(got) | set(want)
                         if got.get(n) != want.get(n))
            fail(f"{name}: state bytes differ from opt_bytes_for at "
                 f"{bad[:4]}")
        if launches != want_launches or not np.isfinite(loss):
            fail(f"{name}: step launched {launches} (the reference's "
                 f"program {want_launches}), loss {loss}")
        del state, params, batch, step, metrics
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 5c and 6c: the enc-dec seamless-m4t-large-v2
# ---------------------------------------------------------------------------


def model_batch(model, gen: torch.Generator, n_batch: int, n_tokens: int,
                kind: str = "prefill") -> dict:
    """Random inputs of ``model.batch_spec`` (token ids; the enc-dec's
    stub speech frontend frames too; labels for ``kind="train"``), as the
    measurement grid makes a cell's inputs."""
    return ME.make_batch(model, ME.MeasureCell(model.cfg.name, kind,
                                               n_tokens, n_batch), gen)


def serve_seamless_m4t_large_v2() -> dict:
    """seamless-m4t-large-v2 at full width and depth (24 encoder + 24
    decoder layers) with random bf16 weights from a seeded generator on
    the card: 4 requests of 2,048 frames and 2,048 prompt tokens, 32
    greedy tokens through ``generate``, then the same program phase by
    phase; launches against the reference's program, the prefill through
    the kernels against the plain versions, the reduced config on the card
    against the CPU."""
    t_phase = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH)
    model = build_model(cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    torch.cuda.synchronize()
    at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(gen, DEV)
    batch = model_batch(model, gen, ENCDEC_BATCH, ENCDEC_PROMPT)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B_, S = ENCDEC_BATCH, ENCDEC_PROMPT
    n_frames = batch["frames"].shape[1]

    tokens, generate_s = serve_generate(model, params, batch, ENCDEC_NEW)
    main_launches = serve_counts()
    if SF.launches or SC.launches or SSD.launches or FL.dq_launches or \
            FL.dkv_launches or RN.bwd_launches:
        fail(f"seamless serving launched another kernel: {model_counts()}")

    def after_prefill(logits, cache):
        hd, L = cfg.resolved_head_dim, cfg.n_layers
        for key, n in (("k", S), ("v", S), ("cross_k", n_frames),
                       ("cross_v", n_frames)):
            leaf = cache["blocks"][key]
            shape = (L, B_, n, cfg.n_kv_heads, hd)
            if tuple(leaf.shape) != shape or leaf.dtype != torch.bfloat16:
                fail(f"seamless prefill cache {key}: {leaf.dtype} "
                     f"{tuple(leaf.shape)}, expected bf16 {shape}")
        if not bool((cache["len"] == S).all()):
            fail("seamless prefill cache len")
        # the kernel path against the same prefill through the plain
        # versions (the gate), each against the fp32 plain prefill (a
        # reading)
        with PlainKernels():
            plain_logits, _ = SV.make_prefill_step(model)(params, batch)
        checked = logits_agree(logits[:, -1], plain_logits[:, -1],
                               "seamless prefill kernel path vs plain path",
                               problems)
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        params32 = copy.deepcopy(params).float()
        batch32 = dict(batch, frames=batch["frames"].float())
        with PlainKernels():
            ref, _ = SV.make_prefill_step(model32)(params32, batch32)
        checked["vs_fp32_plain"] = {
            "kernels": _rel(logits[:, -1], ref[:, -1]),
            "plain": _rel(plain_logits[:, -1], ref[:, -1])}
        del model32, params32, batch32, ref, plain_logits
        gc.collect()
        torch.cuda.empty_cache()
        return checked
    problems = []
    phases = serve_by_phase(model, params, batch, tokens, serve_counts,
                            after_prefill)

    # the reference's program: flash for each encoder block and for each
    # decoder block's self and cross attention in the prefill, none in
    # decode; RMSNorm 2 per encoder block + its final norm, 4 per decoder
    # block (norm1 twice: _prefill_kv and the block) + the final norm in
    # the prefill, 3 per decoder block + the final norm per decode step
    Le, Ld, n_steps = cfg.encdec.n_enc_layers, cfg.n_layers, \
        phases["n_steps"]
    check_launches("seamless serving", phases, main_launches, {
        "prefill": {"flash_fwd": Le + 2 * Ld,
                    "rmsnorm_fwd": 2 * Le + 1 + 4 * Ld + 1},
        "decode": {"flash_fwd": 0,
                   "rmsnorm_fwd": n_steps * (3 * Ld + 1)}})

    # the port's own predictor for the same request (planner.check, the
    # XLA byte model, backend="tpu", one device)
    preds = {}
    for kind, seq in (("prefill", S), ("decode", S + ENCDEC_NEW)):
        rep = PL.check(ENCDEC_ARCH, ShapeConfig("serve", seq, B_, kind), {},
                       backend="tpu", chip="h100")
        p = rep.prediction
        preds[kind] = {"peak_bytes": p.peak_bytes,
                       "param_bytes": p.param_bytes,
                       "cache_bytes": p.cache_bytes,
                       "act_transient_bytes": p.act_transient_bytes,
                       "input_bytes": p.input_bytes, "fits_h100": rep.fits}
    out = {
        "arch": ENCDEC_ARCH, "requests": B_, "prompt_tokens": S,
        "encoder_frames": n_frames, "new_tokens": ENCDEC_NEW,
        "encoder_layers": Le, "decoder_layers": Ld,
        "params": sum(t.numel() for t in params.parameters()),
        "init_s": init_s, "resident_at_start_bytes": at_start,
        **serve_readings(B_, ENCDEC_NEW, generate_s, main_launches, phases,
                         preds),
        "prefill_vs_plain": phases["checked"],
    }
    del params, batch, phases
    gc.collect()
    torch.cuda.empty_cache()
    out["reduced_card_vs_cpu"] = reduced_card_vs_cpu(
        ENCDEC_ARCH, lambda cfg, gen: model_batch(build_model(cfg), gen, 2,
                                                   8),
        serve_counts)
    out["elapsed_s"] = time.perf_counter() - t_phase
    say("serve_seamless_m4t_large_v2 " + json.dumps(out))
    if problems:
        fail("; ".join(problems))
    return out


def train_seamless_m4t_large_v2() -> dict:
    """seamless-m4t-large-v2 at full width and depth, FULL_TRAIN, AdamW,
    remat "block", 4 x 2,048 (frames and tokens), TRAIN_STEPS steps: the
    training phase's readings and gates (the loss finite and moving,
    launches per step the reference's program, the fp32 paths' gradients
    against float64 at the trained weights: :func:`float64_witness`); the
    line prints before its gates can fail the run."""
    t_phase = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH)
    problems = []
    out = train_phase(
        "train_seamless_m4t_large_v2", cfg, FULL_TRAIN,
        "none: full width and depth", problems,
        make_batch=lambda cfg, gen: model_batch(
            build_model(cfg), gen, ENCDEC_TRAIN_BATCH, ENCDEC_PROMPT,
            "train"),
        n_batch=ENCDEC_TRAIN_BATCH, seq_len=ENCDEC_PROMPT, fp64_witness=True)
    out["elapsed_s"] = time.perf_counter() - t_phase
    say("train_seamless_m4t_large_v2 " + json.dumps(out))
    if problems:
        fail("; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 6d: training mamba2-1.3b
# ---------------------------------------------------------------------------


def train_mamba2_1_3b() -> dict:
    """mamba2-1.3b at full width and depth (48 layers), FULL_TRAIN, AdamW,
    remat "block", 4 x 2,048 tokens, TRAIN_STEPS steps through the chunked
    SSD in plain tensor ops: the training phase's readings and gates (the
    loss finite and moving, launches per step the reference's program:
    RMSNorm only; the fp32 paths' gradients against float64 at the trained
    weights), then the reduced config's step on the card against the CPU;
    the line prints before its gates can fail the run."""
    t_phase = time.perf_counter()
    cfg = get_config(MAMBA_ARCH)
    problems = []
    out = train_phase(
        "train_mamba2_1_3b", cfg, FULL_TRAIN, "none: full width and depth",
        problems, make_batch=lambda cfg, gen: model_batch(
            build_model(cfg), gen, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ,
            "train"),
        n_batch=MAMBA_TRAIN_BATCH, seq_len=MAMBA_TRAIN_SEQ,
        fp64_witness=True, profile=False)
    out["reduced_card_vs_cpu"] = reduced_train_card_vs_cpu(
        problems, MAMBA_ARCH, FULL_TRAIN,
        lambda cfg, gen: model_batch(build_model(cfg), gen, 2, 40, "train"))
    out["elapsed_s"] = time.perf_counter() - t_phase
    say("train_mamba2_1_3b " + json.dumps(out))
    if problems:
        fail("; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phases 5d and 6e: the MoE arctic-480b
# ---------------------------------------------------------------------------


def serve_arctic_480b_2l() -> dict:
    """arctic-480b at full published width with its depth cut to 2 of 35
    layers, random bf16 weights made on the card one leaf at a time from a
    seeded generator, under ``mesh_context(MOE_MESH)``: 4 prompts of 1,024
    tokens, 16 greedy tokens through ``generate``, then the same program
    phase by phase; launches against the reference's program, the prefill
    through the kernels against the plain versions (2e-2 of scale), the
    share of (token, expert) pairs the capacity drops and of tokens whose
    top-2 set differs between the two paths, peaks beside the byte model's
    prediction for the depth-2 config."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    model = build_model(cfg)
    meta = MOE.moe_spec("ffn", cfg.d_model, cfg.moe, cfg.dtype).meta
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(gen, DEV)
    batch = model_batch(model, gen, MOE_BATCH, MOE_PROMPT)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    B_, S = MOE_BATCH, MOE_PROMPT
    problems = []
    with mesh_context(MOE_MESH):
        with RouteLog() as gen_routes:
            tokens, generate_s = serve_generate(model, params, batch,
                                                MOE_NEW)
        main_launches = serve_counts()
        if SF.launches or SC.launches or SSD.launches or FL.dq_launches or \
                FL.dkv_launches or RN.bwd_launches:
            fail(f"arctic serving launched another kernel: "
                 f"{model_counts()}")

        def after_prefill(logits, cache):
            hd = cfg.resolved_head_dim
            shape = (MOE_LAYERS, B_, S, cfg.n_kv_heads, hd)
            for key in ("k", "v"):
                leaf = cache["blocks"][key]
                if tuple(leaf.shape) != shape or \
                        leaf.dtype != torch.bfloat16:
                    fail(f"arctic prefill cache {key}: {leaf.dtype} "
                         f"{tuple(leaf.shape)}, expected bf16 {shape}")
            if not bool((cache["len"] == S).all()):
                fail("arctic prefill cache len")
            # the kernel path against the same prefill through the plain
            # versions (the gate), and the routing each path chose
            with RouteLog() as kernel_routes:
                SV.make_prefill_step(model)(params, batch)
            with PlainKernels(), RouteLog() as plain_routes:
                plain_logits, _ = SV.make_prefill_step(model)(params, batch)
            checked = logits_agree(logits[:, -1], plain_logits[:, -1],
                                   "arctic prefill kernel path vs plain "
                                   "path", problems)
            checked["routing_flips"] = flipped(kernel_routes, plain_routes)
            checked["prefill_dropped"] = kernel_routes.dropped(
                meta["n_experts"], meta["top_k"], meta["capacity_factor"])
            del plain_logits
            gc.collect()
            torch.cuda.empty_cache()
            return checked
        phases = serve_by_phase(model, params, batch, tokens, serve_counts,
                                after_prefill)

    # the reference's program: one flash call per block in the prefill and
    # none in decode; RMSNorm 3 per block (norm1 twice: _prefill_kv and the
    # block) + final in the prefill, 2 per block + final per decode step
    n_steps = phases["n_steps"]
    check_launches("arctic serving", phases, main_launches, {
        "prefill": {"flash_fwd": MOE_LAYERS,
                    "rmsnorm_fwd": 3 * MOE_LAYERS + 1},
        "decode": {"flash_fwd": 0,
                   "rmsnorm_fwd": n_steps * (2 * MOE_LAYERS + 1)}})

    # the port's own predictor for the same request on the depth-2 config
    # (the XLA byte model, backend="tpu", the 1 x 1 mesh)
    preds = {}
    for kind, seq in (("prefill", S), ("decode", S + MOE_NEW)):
        p = PR.predict(model, FULL_TRAIN, PL.make_context(
            cfg, MOE_MESH, kind=kind, global_batch=B_, seq_len=seq,
            backend="tpu"), chip="h100")
        preds[kind] = {"peak_bytes": p.peak_bytes,
                       "param_bytes": p.param_bytes,
                       "cache_bytes": p.cache_bytes,
                       "act_transient_bytes": p.act_transient_bytes,
                       "input_bytes": p.input_bytes}
    out = {
        "arch": MOE_ARCH, "cut": f"depth {MOE_LAYERS} of "
        f"{get_config(MOE_ARCH).n_layers} layers (full width)",
        "mesh": MOE_MESH, "requests": B_, "prompt_tokens": S,
        "new_tokens": MOE_NEW, "n_layers": MOE_LAYERS,
        "experts": meta["n_experts"], "top_k": meta["top_k"],
        "capacity_factor": meta["capacity_factor"],
        "params": sum(t.numel() for t in params.parameters()),
        "param_bytes": sum(t.numel() * t.element_size()
                           for t in params.parameters()),
        "init_s": init_s, "init_peak_bytes": init_peak,
        "resident_at_start_bytes": at_start,
        **serve_readings(B_, MOE_NEW, generate_s, main_launches, phases,
                         preds),
        "prefill_tokens_per_s": B_ * S / phases["prefill_s"],
        "dropped": {"generate": gen_routes.dropped(
            meta["n_experts"], meta["top_k"], meta["capacity_factor"])},
        "prefill_vs_plain": phases["checked"],
    }
    del params, batch, phases
    gc.collect()
    torch.cuda.empty_cache()
    out["elapsed_s"] = time.perf_counter() - t_phase
    say("serve_arctic_480b_2l " + json.dumps(out))
    if problems:
        fail("; ".join(problems))
    return out


def train_arctic_reduced() -> dict:
    """The reduced arctic (2 layers, d_model 64, 4 experts top-2, dense
    residual), the same weights and batch on the card (kernels) and on
    the CPU (plain versions) under ``mesh_context(MOE_MESH)``, 3 Adafactor
    steps: loss and gradients card against CPU within ``MOE_TOL`` of
    scale; the routing flips a reading."""
    t_phase = time.perf_counter()
    problems = []
    with mesh_context(MOE_MESH):
        out = reduced_train_card_vs_cpu(
            problems, MOE_ARCH, FULL_TRAIN,
            lambda cfg, gen: model_batch(build_model(cfg), gen, 2, 32,
                                         "train"),
            optimizer="adafactor", steps=TRAIN_STEPS, tol=MOE_TOL)
    out["elapsed_s"] = time.perf_counter() - t_phase
    say("train_arctic_reduced " + json.dumps(out))
    if problems:
        fail("; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phases 5e, 5f and 6f: the MLA family
# ---------------------------------------------------------------------------


def mla_program(cfg, n_steps: int) -> dict:
    """The reference's launches: flash once per block in the prefill and
    none in decode; RMSNorm per block in the prefill norm1 twice (its
    ``_prefill_kv`` and the block), norm2, kv_norm twice (``_prefill_kv``
    and the attention) and q_norm once (``_prefill_kv`` makes no q), the
    final norm once; per decode step norm1, norm2, kv_norm, q_norm and the
    final norm."""
    n, q = cfg.n_layers, int(bool(cfg.mla.q_lora_rank))
    return {"prefill": {"flash_fwd": n, "rmsnorm_fwd": (5 + q) * n + 1},
            "decode": {"flash_fwd": 0,
                       "rmsnorm_fwd": n_steps * ((3 + q) * n + 1)}}


def mla_prefill_paths(cfg, model, params, batch) -> dict:
    """The full-size prefill through the kernels and through the plain
    versions on the same weights and tokens, in bf16 and in fp32 (the
    weights cast IN PLACE: deepseek's fp32 copy beside its bf16 weights
    would not fit the card; call it last), every path under the bf16
    kernel path's routing (``RouteReplay``); as each path's last-position
    logits, every pair's distance over their scale (:func:`_rel`; the
    cache's latents are bf16 on every path, so they are no fp32
    comparison).  Readings beside: the bf16
    pair by the serving tests' 2e-2 of scale (``logits_agree``), and the
    routing flips and capacity drops of the plain path left to route
    itself (an MoE config)."""
    runs = {}

    def run(tag, mdl):
        logits, cache = SV.make_prefill_step(mdl)(params, batch)
        runs[tag] = logits[:, -1].float()
        del logits, cache

    out = {}
    with RouteLog() as routes:
        run("bf16_kernels", model)
    with PlainKernels(), RouteReplay(routes):
        run("bf16_plain", model)
    if cfg.moe:
        meta = MOE.moe_spec("ffn", cfg.d_model, cfg.moe, cfg.dtype).meta
        with PlainKernels(), RouteLog() as free:
            SV.make_prefill_step(model)(params, batch)
        out["free_plain_routing_flips"] = flipped(routes, free)
        out["prefill_dropped"] = routes.dropped(
            meta["n_experts"], meta["top_k"], meta["capacity_factor"])
    out["bf16_kernels_vs_bf16_plain_2e-2"] = logits_agree(
        runs["bf16_kernels"], runs["bf16_plain"], "", [])
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params.float()                      # in place
    gc.collect()
    torch.cuda.empty_cache()
    with RouteReplay(routes):
        run("fp32_kernels", model32)
    with PlainKernels(), RouteReplay(routes):
        run("fp32_plain", model32)
    for a, b in (("fp32_kernels", "fp32_plain"),
                 ("bf16_kernels", "bf16_plain"),
                 ("bf16_kernels", "fp32_plain"),
                 ("bf16_plain", "fp32_plain")):
        out[f"{a}_vs_{b}"] = {"logits": _rel(runs[a], runs[b])}
    # greedy tokens, fp32: equal wherever the plain path's top-2 margin
    # exceeds twice the fp32 tolerance of the logits' scale
    want = runs["fp32_plain"]
    scale = max(1.0, float(want.abs().max()))
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * MAMBA_FP32_TOL * scale
    same = runs["fp32_kernels"].argmax(-1) == want.argmax(-1)
    out["fp32_tokens"] = {"clear": int(clear.sum()),
                          "same_where_clear": int(same[clear].sum()),
                          "same": int(same.sum()), "of": int(same.numel())}
    out["logits_scale"] = float(runs["bf16_plain"].abs().max())
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_mla(arch: str, mesh) -> dict:
    """``arch`` at full published width and depth, random bf16 weights made
    on the card from a seeded generator, under ``mesh_context(mesh)``:
    MLA_BATCH prompts of MLA_PROMPT tokens, MLA_NEW greedy tokens through
    ``generate``, then the same program phase by phase; the cache's
    latent / rope-key leaves, launches against the reference's program,
    the prefill through the kernels against the plain versions (2e-2 of
    scale, a reading), an MoE config's capacity drops and routing flips,
    peaks beside the byte model's prediction; then the prefill's four
    paths (:func:`mla_prefill_paths`, the weights cast to fp32 in place)
    and their gates (:func:`check_deep_paths`): 27 / 62 random bf16
    layers grow the two bf16 paths' distance past 2e-2 of scale, and
    deepseek's routing flips between them (PERF.md § 6)."""
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    model = build_model(cfg)
    meta = MOE.moe_spec("ffn", cfg.d_model, cfg.moe, cfg.dtype).meta \
        if cfg.moe else None
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(gen, DEV)
    batch = model_batch(model, gen, MLA_BATCH, MLA_PROMPT)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    B_, S = MLA_BATCH, MLA_PROMPT
    problems = []
    with mesh_context(mesh):
        with RouteLog() as gen_routes:
            tokens, generate_s = serve_generate(model, params, batch,
                                                MLA_NEW)
        main_launches = serve_counts()
        if SF.launches or SC.launches or SSD.launches or FL.dq_launches or \
                FL.dkv_launches or RN.bwd_launches:
            fail(f"{arch} serving launched another kernel: {model_counts()}")

        def after_prefill(logits, cache):
            m = cfg.mla
            n_dense = cfg.moe.n_dense_layers if cfg.moe else 0
            stacks = {"blocks": cfg.n_layers - n_dense}
            if n_dense:
                stacks["dense_blocks"] = n_dense
            if set(cache) != set(stacks) | {"len"}:
                fail(f"{arch} prefill cache stacks {sorted(cache)}")
            for key, n in stacks.items():
                for leaf, w in (("latent", m.kv_lora_rank),
                                ("k_rope", m.qk_rope_head_dim)):
                    t = cache[key][leaf]
                    if tuple(t.shape) != (n, B_, S, w) or \
                            t.dtype != torch.bfloat16 or set(cache[key]) \
                            != {"latent", "k_rope"}:
                        fail(f"{arch} prefill cache {key}.{leaf}: {t.dtype} "
                             f"{tuple(t.shape)}, expected bf16 "
                             f"{(n, B_, S, w)}")
            if not bool((cache["len"] == S).all()):
                fail(f"{arch} prefill cache len")
            return {}
        phases = serve_by_phase(model, params, batch, tokens, serve_counts,
                                after_prefill)
        del phases["checked"]
    check_launches(f"{arch} serving", phases, main_launches,
                   mla_program(cfg, phases["n_steps"]))

    # the port's own predictor for the same request (the XLA byte model,
    # backend="tpu", the 1 x 1 mesh)
    preds = {}
    for kind, seq in (("prefill", S), ("decode", S + MLA_NEW)):
        p = PR.predict(model, FULL_TRAIN, PL.make_context(
            cfg, MOE_MESH, kind=kind, global_batch=B_, seq_len=seq,
            backend="tpu"), chip="h100")
        preds[kind] = {"peak_bytes": p.peak_bytes,
                       "param_bytes": p.param_bytes,
                       "cache_bytes": p.cache_bytes,
                       "act_transient_bytes": p.act_transient_bytes,
                       "input_bytes": p.input_bytes}
    m = cfg.mla
    out = {
        "arch": arch, "cut": "none: full width and depth", "mesh": mesh,
        "requests": B_, "prompt_tokens": S, "new_tokens": MLA_NEW,
        "n_layers": cfg.n_layers,
        "head_dims": [m.qk_nope_head_dim + m.qk_rope_head_dim,
                      m.v_head_dim],
        "kv_lora_rank": m.kv_lora_rank, "q_lora_rank": m.q_lora_rank,
        "params": sum(t.numel() for t in params.parameters()),
        "param_bytes": sum(t.numel() * t.element_size()
                           for t in params.parameters()),
        "init_s": init_s, "init_peak_bytes": init_peak,
        "resident_at_start_bytes": at_start,
        **serve_readings(B_, MLA_NEW, generate_s, main_launches, phases,
                         preds),
        "prefill_tokens_per_s": B_ * S / phases["prefill_s"],
    }
    if meta:
        out.update(experts=meta["n_experts"], top_k=meta["top_k"],
                   capacity_factor=meta["capacity_factor"],
                   dropped={"generate": gen_routes.dropped(
                       meta["n_experts"], meta["top_k"],
                       meta["capacity_factor"])})
    del phases
    gc.collect()
    torch.cuda.empty_cache()
    with mesh_context(mesh):
        out["prefill_vs_plain"] = mla_prefill_paths(cfg, model, params,
                                                    batch)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["elapsed_s"] = time.perf_counter() - t_phase
    say(f"serve_{arch.replace('-', '_').replace('.', '_')} "
        + json.dumps(out))
    check_deep_paths(arch, out["prefill_vs_plain"], problems)
    if problems:
        fail("; ".join(problems))
    return out


def train_minicpm3_4b() -> dict:
    """minicpm3-4b at full width and depth (62 layers), FULL_TRAIN,
    Adafactor, remat "block", MLA_TRAIN_BATCH x MLA_PROMPT tokens,
    TRAIN_STEPS steps: the training phase's readings and gates (the loss
    finite and moving, launches per step the reference's program: flash
    forward, dq and dk / dv at (96, 64), RMSNorm at 768 / 256 / 2,560; the
    fp32 paths' gradients against float64 at the trained weights, on
    MLA_CHECK_BATCH sample); the line prints before its gates can fail
    the run."""
    t_phase = time.perf_counter()
    cfg = get_config("minicpm3-4b")
    problems = []
    out = train_phase(
        "train_minicpm3_4b", cfg, FULL_TRAIN, "none: full width and depth",
        problems, make_batch=lambda cfg, gen: model_batch(
            build_model(cfg), gen, MLA_TRAIN_BATCH, MLA_PROMPT, "train"),
        n_batch=MLA_TRAIN_BATCH, seq_len=MLA_PROMPT, fp64_witness=True,
        optimizer="adafactor", check_batch=MLA_CHECK_BATCH)
    out["elapsed_s"] = time.perf_counter() - t_phase
    say("train_minicpm3_4b " + json.dumps(out))
    if problems:
        fail("; ".join(problems))
    return out


def reduced_mla() -> dict:
    """The reduced MLA archs, deepseek-v2-lite-16b (MoE, 4 experts top-2
    and a shared expert, a leading dense block, under
    ``mesh_context(MOE_MESH)``) and minicpm3-4b (dense, q rank 32), whose
    attention pairs qk 16 + 8 = 24 with v 16: no compiled pair, so the
    flash kernels run zero-padded on ``FL.instance_for(24, 16)``.  Each,
    the same weights on the card (kernels) and on the CPU (plain
    versions): prefill + 4 decode steps, then one Adafactor step under
    FULL_TRAIN, within its family's card-vs-CPU bound (deepseek the MoE's
    MOE_TOL, its routing flips a reading; minicpm3 2e-2 of each tensor's
    scale); the flash launches at (24, 16), forward and both backward
    passes, counted and above 0.  Their launches are a check's, not the
    main path's."""
    t_phase = time.perf_counter()
    problems, out = [], {}

    def tokens(cfg, gen):
        return {"tokens": torch.randint(0, cfg.vocab, (2, 40), generator=gen,
                                        dtype=torch.int32)}

    def train(cfg, gen):
        return model_batch(build_model(cfg), gen, 2, 40, "train")
    for arch, mesh, tol in (("deepseek-v2-lite-16b", MOE_MESH, MOE_TOL),
                            ("minicpm3-4b", None, 2e-2)):
        m = get_config(arch).reduced().mla
        pair = (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim)
        row = {"head_dims": list(pair),
               "instance": list(FL.instance_for(*pair)), "tolerance": tol}
        with mesh_context(mesh):
            row["serve"] = reduced_card_vs_cpu(arch, tokens, serve_counts,
                                               tol=tol)
            row["train"] = reduced_train_card_vs_cpu(
                problems, arch, FULL_TRAIN, train, optimizer="adafactor",
                tol=tol)
        flash = [row["serve"]["launches"]["flash_fwd"]] + [
            row["train"]["launches"][k]
            for k in ("flash_fwd", "flash_dq", "flash_dkv")]
        if pair != (24, 16) or min(flash) <= 0:
            problems.append(f"reduced {arch}: head dims {pair}, flash "
                            f"launches {flash}")
        out[arch] = row
    out["elapsed_s"] = time.perf_counter() - t_phase
    say("reduced_mla " + json.dumps(out))
    if problems:
        fail("; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phases 5g and 6g: the hybrid zamba2-2.7b
# ---------------------------------------------------------------------------


def hybrid_counts() -> dict:
    return {"flash_fwd": FL.launches, "ssd_scan": SSD.launches,
            "rmsnorm_fwd": RN.launches}


def hybrid_program(cfg, n_steps: int) -> dict:
    """The reference's launches: per prefill one flash forward per shared
    invocation, one SSD per mamba block, RMSNorm twice per mamba block
    (block norm, gated norm), three times per invocation (norm1 again for
    the cached K/V, norm2) and the final norm; per decode step no flash
    and no SSD, RMSNorm twice per block and per invocation and the final
    norm."""
    n, inv = cfg.n_layers, cfg.n_layers // cfg.hybrid.attn_every
    return {"prefill": {"flash_fwd": inv, "ssd_scan": n,
                        "rmsnorm_fwd": 2 * n + 3 * inv + 1},
            "decode": {"flash_fwd": 0, "ssd_scan": 0,
                       "rmsnorm_fwd": n_steps * (2 * n + 2 * inv + 1)}}


def serve_zamba2_2_7b() -> dict:
    """zamba2-2.7b at full width and depth (54 mamba blocks, 9 shared
    invocations) with random bf16 weights from a seeded generator on the
    card: HYBRID_BATCH requests x HYBRID_PROMPT prompt tokens, HYBRID_NEW
    greedy tokens through ``generate``, then the same program phase by
    phase; the cache's SSM and K/V leaves, launches against the
    reference's program, peaks beside the byte model; the prefill's four
    paths (:func:`mamba_prefill_paths`) and mamba2's gates on them
    (:func:`check_deep_paths`: fp32 kernel vs plain path, logits and
    states, 1e-3 of scale; the bf16 kernel path no further from fp32 than
    1.5x the bf16 plain path), the bf16 pair at 2e-2 a reading; the
    reduced config on the card against the CPU."""
    t_phase = time.perf_counter()
    cfg = get_config(HYBRID_ARCH)
    model = build_model(cfg)
    meta = model.spec.children[2].layers[1].meta
    n_inv = cfg.n_layers // cfg.hybrid.attn_every
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(gen, DEV)
    batch = model_batch(model, gen, HYBRID_BATCH, HYBRID_PROMPT)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B_, S = HYBRID_BATCH, HYBRID_PROMPT
    problems = []

    tokens, generate_s = serve_generate(model, params, batch, HYBRID_NEW)
    main_launches = hybrid_counts()
    if SF.launches or SC.launches or FL.dq_launches or FL.dkv_launches \
            or RN.bwd_launches:
        fail(f"zamba2 serving launched another kernel: {model_counts()}")

    def after_prefill(logits, cache):
        H, P, N = meta["n_heads"], meta["head_dim"], meta["d_state"]
        kv = (n_inv, B_, S, cfg.n_kv_heads, cfg.resolved_head_dim)
        want = {("blocks", "ssm"): ((cfg.n_layers, B_, H, P, N),
                                    torch.float32),
                ("blocks", "conv"): ((cfg.n_layers, B_, meta["d_conv"] - 1,
                                      meta["conv_ch"]), torch.bfloat16),
                ("attn", "k"): (kv, torch.bfloat16),
                ("attn", "v"): (kv, torch.bfloat16)}
        if set(cache) != {"blocks", "attn", "len"}:
            fail(f"zamba2 prefill cache {sorted(cache)}")
        for (group, key), (shape, dtype) in want.items():
            leaf = cache[group][key]
            if tuple(leaf.shape) != shape or leaf.dtype != dtype or \
                    not bool(torch.isfinite(leaf.float()).all()):
                fail(f"zamba2 prefill cache {group}.{key}: {leaf.dtype} "
                     f"{tuple(leaf.shape)}, expected {dtype} {shape}")
        if not bool((cache["len"] == S).all()):
            fail("zamba2 prefill cache len")
        paths = mamba_prefill_paths(cfg, params, batch)
        check_deep_paths("zamba2", paths, problems)
        return paths
    phases = serve_by_phase(model, params, batch, tokens, hybrid_counts,
                            after_prefill)
    check_launches("zamba2 serving", phases, main_launches,
                   hybrid_program(cfg, phases["n_steps"]))

    # the port's own predictor for the same request (planner.check, the
    # XLA byte model, backend="tpu", one device)
    preds = {}
    for kind, seq in (("prefill", S), ("decode", S + HYBRID_NEW)):
        rep = PL.check(HYBRID_ARCH, ShapeConfig("serve", seq, B_, kind), {},
                       backend="tpu", chip="h100")
        p = rep.prediction
        preds[kind] = {"peak_bytes": p.peak_bytes,
                       "param_bytes": p.param_bytes,
                       "cache_bytes": p.cache_bytes,
                       "act_transient_bytes": p.act_transient_bytes,
                       "input_bytes": p.input_bytes,
                       "fits_h100": rep.fits}
    out = {
        "arch": HYBRID_ARCH, "cut": "none: full width and depth",
        "requests": B_, "prompt_tokens": S, "new_tokens": HYBRID_NEW,
        "n_layers": cfg.n_layers, "shared_invocations": n_inv,
        "shared_blocks": cfg.hybrid.shared_attn_blocks,
        "params": sum(t.numel() for t in params.parameters()),
        "param_bytes": sum(t.numel() * t.element_size()
                           for t in params.parameters()),
        "init_s": init_s, "resident_at_start_bytes": at_start,
        **serve_readings(B_, HYBRID_NEW, generate_s, main_launches, phases,
                         preds),
        "prefill_tokens_per_s": B_ * S / phases["prefill_s"],
        "prefill_vs_plain": phases["checked"],
    }
    del params, batch, phases
    gc.collect()
    torch.cuda.empty_cache()
    out["reduced_card_vs_cpu"] = reduced_card_vs_cpu(
        HYBRID_ARCH, lambda cfg, gen: {"tokens": torch.randint(
            0, cfg.vocab, (2, 40), generator=gen, dtype=torch.int32)},
        hybrid_counts)
    out["elapsed_s"] = time.perf_counter() - t_phase
    say("serve_zamba2_2_7b " + json.dumps(out))
    if problems:
        fail("; ".join(problems))
    return out


def train_zamba2_2_7b() -> dict:
    """zamba2-2.7b at full width and depth, FULL_TRAIN, AdamW, remat
    "block", HYBRID_TRAIN_BATCH x HYBRID_PROMPT tokens, TRAIN_STEPS steps:
    the training phase's readings and gates (the loss finite and moving,
    every trainable leaf moved, launches per step the reference's
    program: flash forward, dq and dk / dv once per shared invocation at
    (80, 80), RMSNorm both ways at 2,560 / 5,120; the fp32 paths'
    gradients against float64 at the trained weights, on
    HYBRID_CHECK_BATCH sample), then the reduced config's step on the card
    against the CPU; the line prints before its gates can fail the run."""
    t_phase = time.perf_counter()
    cfg = get_config(HYBRID_ARCH)
    problems = []
    out = train_phase(
        "train_zamba2_2_7b", cfg, FULL_TRAIN, "none: full width and depth",
        problems, make_batch=lambda cfg, gen: model_batch(
            build_model(cfg), gen, HYBRID_TRAIN_BATCH, HYBRID_PROMPT,
            "train"),
        n_batch=HYBRID_TRAIN_BATCH, seq_len=HYBRID_PROMPT, fp64_witness=True,
        optimizer="adamw", check_batch=HYBRID_CHECK_BATCH, profile=False)
    # the params after AdamW's first step are a reading: the step moves
    # each element by about lr x sign(grad), so an element of a
    # zero-initialized leaf whose gradient is a rounding from zero lands
    # 2 lr apart on the two devices — 2.0 of the leaf's scale (conv_b,
    # PERF.md § 6) while the gradients agree within tol
    out["reduced_card_vs_cpu"] = reduced_train_card_vs_cpu(
        problems, HYBRID_ARCH, FULL_TRAIN,
        lambda cfg, gen: model_batch(build_model(cfg), gen, 2, 40, "train"),
        params_gate=False)
    out["elapsed_s"] = time.perf_counter() - t_phase
    say("train_zamba2_2_7b " + json.dumps(out))
    if problems:
        fail("; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 4i: the memory autopilot
# ---------------------------------------------------------------------------


def autopilot_scenarios(problems: list) -> dict:
    """Every drift scenario, guarded and unguarded, at v5e and h100,
    through the port's defaults (the guard's reshard search on the card;
    the scenarios never reach it): each ``ScenarioResult`` field against
    the reference's (AUTOPILOT_WANT, AUTOPILOT_BYTES)."""
    engine = SW.SweepEngine()
    budget, base, final = AUTOPILOT_BYTES
    rows, t0 = [], time.perf_counter()
    zero_counts()
    for chip in ("v5e", "h100"):
        for r in AP.run_all(engine=engine, chip=chip):
            got = (r.completed, r.aborted, r.steps_done, r.n_steps,
                   tuple(r.oom_steps), tuple(r.mitigations), r.restarts,
                   r.budget_bytes, r.base_predicted_bytes,
                   r.final_predicted_bytes)
            want = AUTOPILOT_WANT[(r.scenario, r.guarded)] + (
                budget, base, final if r.guarded else base)
            if got != want:
                problems.append(f"autopilot {r.scenario} guarded="
                                f"{r.guarded} at {chip}: {got}, the "
                                f"reference's {want}")
            rows.append({"chip": chip, "line": str(r)})
    return {"results": rows, "equal_to_reference": not problems,
            "s": time.perf_counter() - t0,
            "launches": {"shard_factor": SF.launches,
                         "segmented_cummax": SC.launches}}


def autopilot_reshard(problems: list) -> dict:
    """The harness cell's plan at a drift ratio of 50 (no knob move is
    safe, so ``_reshard`` runs ``planner.plan_min_chips``), by the port's
    default planner (the pruned search's slices on the card) and by the
    host's (``compute_engine="numpy"``), each on a cold engine: the
    candidates equal, the reshard candidate the reference's; both waits
    printed (ROADMAP C14); the search launched ``shard_factor``."""
    cold = SW.SweepEngine()
    base = cold.evaluate(AP.base_cell(), policy=FULL_TRAIN).peak_bytes
    hr = (base / AP_HARNESS.BASE_FRAC) / PL.chip_hbm("v5e")
    plans = {}
    for where, kw in (("card", {}), ("host", {"compute_engine": "numpy"})):
        planner = AP.MitigationPlanner(engine=SW.SweepEngine(),
                                       policy=FULL_TRAIN, headroom=hr, **kw)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = planner.plan(AP.base_cell(), ewma_ratio=50.0)
        torch.cuda.synchronize()
        plans[where] = (plan, (time.perf_counter() - t0) * 1e3,
                        {"shard_factor": SF.launches,
                         "segmented_cummax": SC.launches})

    def rows(plan):
        return [(c.action, c.cell, c.predicted_bytes, c.projected_bytes,
                 c.throughput_cost, c.note, c.safe) for c in plan.candidates]
    card, host = plans["card"][0], plans["host"][0]
    if rows(card) != rows(host):
        problems.append("autopilot reshard: the card's plan is not the "
                        "host's")
    rs = [c for c in card.candidates if c.action == "reshard"]
    got = None if not rs else (rs[0].cell.mesh, rs[0].cell.remat,
                               rs[0].cell.grad_accum, rs[0].cell.schedule,
                               rs[0].cell.microbatches,
                               rs[0].predicted_bytes, rs[0].throughput_cost,
                               rs[0].note)
    if got != AUTOPILOT_RESHARD:
        problems.append(f"autopilot reshard {got}, the reference's "
                        f"{AUTOPILOT_RESHARD}")
    if plans["card"][2]["shard_factor"] <= 0 or any(plans["host"][2]
                                                    .values()):
        problems.append(f"autopilot reshard launches: card "
                        f"{plans['card'][2]}, host {plans['host'][2]}")
    return {"candidates": [f"{c}" for c in card.candidates],
            "reshard": {"mesh": dict(got[0]) if got else None,
                        "equal_to_reference": got == AUTOPILOT_RESHARD},
            "card_ms": plans["card"][1], "host_ms": plans["host"][1],
            "launches": plans["card"][2]}


def autopilot_replay(problems: list) -> dict:
    """``ResilientTrainer`` over REPLAY_STEPS real smollm-360m steps on the
    card (8 x 2,048, AdamW, remat "block"), a checkpoint every
    REPLAY_EVERY steps (keep 2, a temporary directory removed at the end),
    a failure injected at step REPLAY_FAIL_AT: the trainer restores the
    step-4 checkpoint (parameters, AdamW state and step) and replays step
    4.  Each step is admission-controlled by an ``Autopilot`` on the
    grid's cell at ``chip="h100"`` fed the allocator's peak of the step
    before.  Gates: the replayed losses and the final parameters bit-equal
    to an uninterrupted run's, the restored tensors on the card, the
    watch SAFE on every step it could read, no mitigation; launches the
    reference's program once per step run."""
    cfg = get_config(REPLAY_ARCH)
    model = build_model(cfg)
    opt = OptimizerConfig(name="adamw")
    step = make_train_step(model, FULL_TRAIN, opt, remat="block")

    def batch(i):
        g = torch.Generator(device=DEV)
        g.manual_seed(SEED + 100 + i)
        return model_batch(model, g, REPLAY_BATCH, REPLAY_SEQ, "train")

    def fresh():
        g = torch.Generator(device=DEV)
        g.manual_seed(SEED)
        return init_train_state(model, FULL_TRAIN, opt, g, DEV)

    gc.collect()
    torch.cuda.empty_cache()
    state, straight = fresh(), []
    for i in range(REPLAY_STEPS):
        state, metrics = step(state, batch(i))
        straight.append(float(metrics["loss"]))
    want = {n: p.detach().cpu() for n, p in state.params.named_parameters()}
    del state, metrics
    gc.collect()
    torch.cuda.empty_cache()

    cell = SW.SweepCell(arch=REPLAY_ARCH, chip="h100",
                        mesh=tuple(sorted(ME.MESH.items())),
                        optimizer="adamw", remat="block", grad_accum=1,
                        global_batch=REPLAY_BATCH, seq_len=REPLAY_SEQ,
                        kind="train", backend=ME.BACKEND)
    pilot = AP.Autopilot(cell=cell, policy=FULL_TRAIN)
    read = []

    def memory_source(i):
        """The allocator's peak since the last read (None before the
        first step: nothing ran yet)."""
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if read else None
        read.append(peak)
        torch.cuda.reset_peak_memory_stats()
        return peak

    failed = []

    def inject(i):
        if i == REPLAY_FAIL_AT and not failed:
            failed.append(i)
            return True
        return False

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        trainer = ResilientTrainer(
            train_step=step, pipeline=None,
            checkpointer=Checkpointer(d, keep=2),
            fault_cfg=FaultConfig(ckpt_every=REPLAY_EVERY), make_batch=batch,
            failure_injector=inject, autopilot=pilot,
            memory_source=memory_source)
        start = fresh()
        zero_counts()
        t0 = time.perf_counter()
        state, history = trainer.run(start, 0, REPLAY_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = model_counts()
        kept = sorted(os.listdir(d))
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, kept[-1], f))
                         for f in os.listdir(os.path.join(d, kept[-1])))
    steps = [h["step"] for h in history]
    losses = [h["loss"] for h in history]
    replay = list(range(REPLAY_FAIL_AT)) + list(
        range(REPLAY_FAIL_AT - 1, REPLAY_STEPS))
    if steps != replay or losses != [straight[i] for i in replay]:
        problems.append(f"autopilot replay: steps {steps} losses {losses}, "
                        f"uninterrupted {straight}")
    differ = [n for n, p in state.params.named_parameters()
              if not torch.equal(p.detach().cpu(), want[n])]
    if differ:
        problems.append(f"autopilot replay: {len(differ)} parameters differ "
                        f"from the uninterrupted run's: {differ[:4]}")
    off_card = [n for n, t in ([(n, p) for n, p in
                                state.params.named_parameters()]
                               + [(f"{k}.{n}", t) for k, d_ in
                                  state.opt.items() for n, t in d_.items()]
                               + [("step", state.step)])
                if t.device.type != "cuda"]
    if off_card:
        problems.append(f"autopilot replay: restored tensors off the card: "
                        f"{off_card[:4]}")
    states = [smp.state.value for smp in pilot.watch.samples]
    if states[0] != "unavailable" or set(states[1:]) != {"safe"} or \
            pilot.applied or pilot.events:
        problems.append(f"autopilot replay watch {states}, applied "
                        f"{pilot.applied}, events {pilot.events}")
    program = {k: v * len(history) for k, v in train_program(cfg).items()}
    if launches != program:
        problems.append(f"autopilot replay launched {launches}, the "
                        f"reference's program {program}")
    if trainer.restarts != 1 or kept != ["step_4", "step_6"]:
        problems.append(f"autopilot replay: restarts {trainer.restarts}, "
                        f"checkpoints kept {kept}")
    samples = pilot.watch.samples
    out = {"arch": REPLAY_ARCH, "batch": REPLAY_BATCH, "seq": REPLAY_SEQ,
           "steps": steps, "losses": losses, "uninterrupted": straight,
           "restarts": trainer.restarts, "checkpoints_kept": kept,
           "checkpoint_bytes": ckpt_bytes, "run_s": run_s,
           "params_bit_equal": not differ,
           "watch": {"states": states,
                     "observed_bytes": [smp.observed_bytes
                                        for smp in samples],
                     "predicted_bytes": pilot.predicted_bytes,
                     "budget_bytes": pilot.budget_bytes,
                     "ewma_ratio": pilot.watch.ewma_ratio},
           "launches": launches}
    del state, start, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def autopilot_phase() -> dict:
    """Phase 4i: the scenarios, the reshard on the card, the real-step
    replay; one ``autopilot`` line, then the gates."""
    t_phase = time.perf_counter()
    problems = []
    out = {"scenarios": autopilot_scenarios(problems),
           "reshard": autopilot_reshard(problems),
           "replay": autopilot_replay(problems)}
    out["elapsed_s"] = time.perf_counter() - t_phase
    say("autopilot " + json.dumps(out))
    if problems:
        fail("; ".join(problems))
    return {k: out["reshard"]["launches"].get(k, 0)
            + out["scenarios"]["launches"].get(k, 0)
            + out["replay"]["launches"].get(k, 0)
            for k in set(out["reshard"]["launches"])
            | set(out["replay"]["launches"])}


# ---------------------------------------------------------------------------
# phase 10: the surface — the configs CLI, the sweep's dry run, the examples
# ---------------------------------------------------------------------------

# the large legacy grid (large_grid("legacy")) as the sweep CLI's flags
LARGE_GRID_FLAGS = [
    "--arch", "llava15_7b", "--chips", "64,128,256",
    "--chip", "v5e,v6e,h100", "--optimizer", "default,adafactor,adamw8bit",
    "--remat", "none,block,dots", "--accum", "1,2,4,8",
    "--batch", "8,16,32,64,128,256,512,1024,2048,4096,8192,16384",
    "--seq-len", "512,1024,2048,4096"]


def surface_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))


def surface_procs(runs: dict, timeout: float = 600) -> dict:
    """``python -m <args>`` for every entry of ``runs``, each a process of
    its own from the checkout, all started together -> name -> standard
    output; a process that exits other than 0 fails the run with its
    error output."""
    started = {}
    for name, args in runs.items():
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        started[name] = (subprocess.Popen(
            [sys.executable, "-m"] + args, stdout=out, stderr=err,
            text=True, env=surface_env(), cwd=HERE), out, err)
    t0, texts, failed = time.perf_counter(), {}, []
    for name, (proc, out, err) in started.items():
        try:
            rc = proc.wait(timeout=max(1.0, timeout
                                       - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        out.seek(0)
        err.seek(0)
        texts[name] = out.read()
        if rc != 0:
            failed.append(f"{name} exited {rc}: {err.read()[-1200:]}")
        out.close()
        err.close()
    if failed:
        fail("surface: " + " | ".join(failed))
    return texts


def cli_in_process(main, argv: list) -> str:
    """A CLI's ``main(argv)`` in this process -> its standard output."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        fail(f"{main.__module__} {argv[:2]}: exit {rc}")
    return buf.getvalue()


def surface_phase() -> dict:
    """The user's surface: (c) the sweep CLI's ``--dry-run`` estimate on
    the large legacy grid beside the same grid run cold on the card (in
    this process, alone on the card); then, each a process of its own, all
    started together: (a) ``python -m repro_torch.configs`` equal to the
    table embedded in ``docs/configs.md`` (the reference's output, read as
    text); (b) two ``--breakdown`` runs; (d) the five examples on the
    card."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    # (c) the dry run's estimate, then the same grid cold on the card
    dry = cli_in_process(SW.main, LARGE_GRID_FLAGS + ["--dry-run"]) \
        .splitlines()
    est = re.match(r"estimated runtime in .*: ~([0-9.]+)s \(([0-9,]+) "
                   r"cells/s — (.*)\)$", dry[-1])
    run = cli_in_process(SW.main, LARGE_GRID_FLAGS + ["--top", "3"])
    got = re.search(r"^(\d+) cells in ([0-9.]+)s \(([0-9,]+) cells/s",
                    run, re.M)
    if est is None or got is None or dry[0] != f"dry run: {124416:,} " \
            f"cells" or int(got.group(1)) != 124416:
        fail(f"the sweep CLI's dry run / cold run: {dry[:1] + dry[-1:]} "
             f"{run.splitlines()[:2]}")
    out["sweep"] = {"cells": 124416, "estimated_s": float(est.group(1)),
                    "estimated_cells_per_s": est.group(2),
                    "estimate_source": est.group(3),
                    "measured_cold_s": float(got.group(2)),
                    "measured_cells_per_s": got.group(3)}
    with tempfile.TemporaryDirectory() as ckpt:
        texts = surface_procs({
            "configs": ["repro_torch.configs"],
            "breakdown_llava_pipe": [
                "repro_torch.configs", "--breakdown", "--arch", "llava15_7b",
                "--mesh", "data=4,model=2,pipe=2", "--microbatches", "4"],
            "breakdown_deepseek_ep_cp": [
                "repro_torch.configs", "--breakdown", "--arch",
                "deepseek-v2-lite-16b", "--mesh",
                "data=2,model=2,expert=4,context=2"],
            "quickstart": ["repro_torch.examples.quickstart"],
            "capacity_plan": ["repro_torch.examples.capacity_plan"],
            "predict_memory": [
                "repro_torch.examples.predict_memory", "--arch",
                "smollm-360m", "--shape", "long_500k", "--data", "1",
                "--model", "1", "--validate", "--hbm-gib", "80"],
            "train_llava_e2e": ["repro_torch.examples.train_llava_e2e",
                                "--steps", "20", "--ckpt-dir", ckpt],
            "serve_batched": ["repro_torch.examples.serve_batched"]})
    # (a) the arch table
    table = texts["configs"].strip().splitlines()
    with open(os.path.join(HERE, "docs", "configs.md")) as f:
        docs = [ln.rstrip("\n") for ln in f if ln.startswith("|")]
    if table != docs:
        fail(f"python -m repro_torch.configs differs from docs/configs.md: "
             f"{[t for t, d in zip(table, docs) if t != d][:2]}")
    out["configs_table_rows"] = len(table) - 2
    # (b) breakdowns: a pipe axis; expert and context axes
    for name in ("breakdown_llava_pipe", "breakdown_deepseek_ep_cp"):
        peak = [ln for ln in texts[name].splitlines()
                if ln.startswith("peak ")]
        if not peak or "per-module breakdown" not in texts[name]:
            fail(f"{name} printed no peak line")
        out[name] = peak[0]
    # (d) the examples
    if "plain Adam would need" not in texts["quickstart"]:
        fail("quickstart printed no OoM guard")
    out["capacity_plan"] = [ln for ln in texts["capacity_plan"].splitlines()
                            if ln.startswith("sweep ")]
    line = [ln for ln in texts["predict_memory"].splitlines()
            if ln.startswith("validation vs")]
    if not line:
        fail("predict_memory --validate printed no validation line")
    out["predict_memory_validate"] = line[0]
    loss = re.search(r"^loss ([-0-9.naif]+) -> ([-0-9.naif]+) over 20 "
                     r"steps", texts["train_llava_e2e"], re.M)
    if loss is None or not (np.isfinite(float(loss.group(1)))
                            and np.isfinite(float(loss.group(2)))
                            and float(loss.group(2)) < float(loss.group(1))):
        fail(f"train_llava_e2e: loss not finite and falling: "
             f"{texts['train_llava_e2e'].splitlines()[-3:]}")
    out["train_llava_e2e"] = [float(loss.group(1)), float(loss.group(2))]
    served = texts["serve_batched"]
    tokens = [int(t) for ln in re.findall(r"generated \[([0-9, ]*)\]",
                                          served)
              for t in ln.split(",")]
    vocab = get_config("smollm-360m").reduced().vocab
    if len(tokens) != 4 * 16 or not all(0 <= t < vocab for t in tokens):
        fail(f"serve_batched: {len(tokens)} tokens, not 64 in [0, {vocab})")
    out["serve_batched"] = [ln.strip() for ln in served.splitlines()
                            if "tok/s" in ln]
    out["elapsed_s"] = time.perf_counter() - t_phase
    say("surface " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 9: the training launcher (python -m repro_torch.launch.train)
# ---------------------------------------------------------------------------

# (c): smollm-360m at published width and depth on the train_4k shape
# (256 x 4,096 tokens a step), AdamW with its fp32 master, 3 steps, with
# the smallest power-of-two accumulation whose step the byte model
# predicts under LAUNCH_BUDGET_GIB at a 1 x 1 mesh on an h100; (d): the
# sharding helpers on a 1 x 1 DeviceMesh of an NCCL world of one, one step
# at LAUNCH_MESH_BATCH x LAUNCH_MESH_SEQ
LAUNCH_ARCH, LAUNCH_SHAPE, LAUNCH_STEPS = "smollm-360m", "train_4k", 3
LAUNCH_BUDGET_GIB = 60
LAUNCH_MESH_BATCH, LAUNCH_MESH_SEQ = 2, 2048


def launch_accum(cfg, shape) -> tuple:
    """(G, the byte model's peak bytes at G): the smallest power of two
    whose step (microbatches of global_batch / G) the byte model predicts
    under LAUNCH_BUDGET_GIB on one h100 (1 x 1 mesh, ``tpu`` terms, remat
    block, AdamW)."""
    model = build_model(cfg)
    G = 1
    while True:
        ctx = PL.make_context(cfg, {"data": 1, "model": 1}, kind="train",
                              global_batch=shape.global_batch,
                              seq_len=shape.seq_len, backend="tpu",
                              grad_accum=G, remat="block", optimizer="adamw")
        peak = PR.predict(model, FULL_TRAIN, ctx, chip="h100").peak_bytes
        if peak < LAUNCH_BUDGET_GIB * 2 ** 30 or G >= shape.global_batch:
            return G, peak
        G *= 2


def sha256_batch(batch: dict) -> str:
    """One digest over a batch's leaves (sorted by name) as host bytes."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(batch):
        v = batch[k]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def launch_check_only(problems: list) -> dict:
    """(a): the planner's report for llava15-7b on the default (16, 16)
    mesh, as ``--check-only`` prints it."""
    from repro_torch.launch import train as LT
    zero_counts()
    rep = LT.main(["--arch", "llava15-7b", "--shape", "train_4k",
                   "--check-only"]).report
    if any(model_counts().values()) or rep is None:
        problems.append("launch --check-only launched a kernel")
    return {"fits": rep.fits, "remat": rep.remat,
            "grad_accum": rep.grad_accum, "peak_bytes": rep.peak_bytes,
            "budget_bytes": rep.budget_bytes, "report": str(rep)}


def launch_guard(problems: list) -> dict:
    """(b): arctic-480b on a 1 x 1 mesh must end in the guard's
    ``SystemExit`` with nothing allocated on the card."""
    from repro_torch.launch import train as LT
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    message = None
    try:
        LT.main(["--arch", "arctic-480b", "--shape", "train_4k", "--data",
                 "1", "--model", "1"])
    except SystemExit as e:
        message = str(e)
    moved = torch.cuda.memory_allocated() - before
    if message is None or not message.startswith("OoM guard"):
        problems.append(f"launch guard: arctic-480b was not refused "
                        f"({message!r})")
    if moved:
        problems.append(f"launch guard: {moved} B allocated by a refused "
                        f"launch")
    return {"refused": message, "allocated_bytes": moved}


def launch_smollm(problems: list) -> tuple:
    """(c): ``main`` trains smollm-360m at published width: per step the
    loss, seconds and tokens/s, launches against the reference's program
    per microbatch x G, the allocator peak beside the byte model's, the
    batches' digests against the host pipeline's, and a 1-microbatch step
    under the profiler (the card's busy share)."""
    from repro_torch.data import SyntheticPipeline
    from repro_torch.launch import train as LT
    cfg = get_config(LAUNCH_ARCH)
    shape = SHAPES[LAUNCH_SHAPE]
    G, predicted = launch_accum(cfg, shape)
    want = {k: v * G * LAUNCH_STEPS for k, v in train_program(cfg).items()}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as d:
        zero_counts()
        t0 = time.perf_counter()
        run = LT.main(["--arch", LAUNCH_ARCH, "--shape", LAUNCH_SHAPE,
                       "--grad-accum", str(G), "--steps", str(LAUNCH_STEPS),
                       "--ckpt-dir", d])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = model_counts()
        peak = torch.cuda.max_memory_allocated()
        kept = sorted(os.listdir(d))
    losses = [h["loss"] for h in run.history]
    if len(losses) != LAUNCH_STEPS or not all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        problems.append(f"launch: losses {losses} not finite and falling")
    if launches != want:
        problems.append(f"launch: launched {launches}, the reference's "
                        f"program x {G} x {LAUNCH_STEPS} steps {want}")
    host = SyntheticPipeline(cfg, shape)
    digests = [(sha256_batch(run.trainer.make_batch(s)),
                sha256_batch(host.global_batch(s)))
               for s in range(LAUNCH_STEPS)]
    if any(a != b for a, b in digests):
        problems.append("launch: a batch on the card differs from the "
                        "host pipeline's")
    if kept != [f"step_{LAUNCH_STEPS}"]:
        problems.append(f"launch: checkpoints {kept}")
    # the card's busy share over one step of one microbatch (the step's
    # G microbatches run the same program G times, its update once)
    micro = {k: v[:shape.global_batch // G]
             for k, v in run.trainer.make_batch(0).items()}
    one = make_train_step(build_model(cfg), FULL_TRAIN, OptimizerConfig())
    t0 = time.perf_counter()
    one(run.state, micro)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    one(run.state, micro)
    torch.cuda.synchronize()
    one_ms = min(one_ms, (time.perf_counter() - t0) * 1e3)
    on_device = device_breakdown(lambda: one(run.state, micro), one_ms,
                                 top=8)
    med = statistics.median(run.step_s[1:] or run.step_s)
    out = {"arch": cfg.name, "cut": "none: full width and depth",
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "vocab": cfg.vocab, "global_batch": shape.global_batch,
           "seq_len": shape.seq_len, "grad_accum": G,
           "microbatch": shape.global_batch // G, "optimizer": "adamw",
           "master_fp32": True, "remat": "block",
           "loss_per_step": losses, "s_per_step": run.step_s,
           "tokens_per_s": shape.global_batch * shape.seq_len / med,
           "main_s": main_s,
           "launches": launches,
           "launches_per_step": {k: v // LAUNCH_STEPS
                                 for k, v in launches.items()},
           "launches_per_microbatch_want": train_program(cfg),
           "measured_peak_bytes": peak, "predicted_peak_bytes": predicted,
           "measured_over_predicted": peak / predicted,
           "batch_sha256": [a for a, _ in digests],
           "checkpoints": kept,
           "one_microbatch_step": {"ms": one_ms, "on_device": on_device}}
    state = run.state
    del run, one, micro
    return out, launches, state


def launch_on_device_mesh(problems: list) -> dict:
    """(d): an NCCL world of one over a FileStore, a 1 x 1 DeviceMesh;
    smollm-360m's parameters and AdamW state placed with
    ``param_shardings`` / ``opt_shardings``, one step at
    LAUNCH_MESH_BATCH x LAUNCH_MESH_SEQ with ``zero_shardings`` bit-equal
    to the same step with no mesh; a checkpoint of the placed state
    restored with ``shardings`` onto the mesh, every leaf bit-equal."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.data import SyntheticPipeline
    from repro_torch.launch import mesh as M
    cfg = get_config(LAUNCH_ARCH)
    model = build_model(cfg)
    opt_cfg = OptimizerConfig()
    shape = ShapeConfig("launch_mesh", LAUNCH_MESH_SEQ, LAUNCH_MESH_BATCH,
                        "train")
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = M.make_smoke_mesh(1, 1)

            def state_of(seed):
                gen = torch.Generator(device=DEV)
                gen.manual_seed(seed)
                return init_train_state(model, FULL_TRAIN, opt_cfg, gen,
                                        DEV)

            plain, placed = state_of(SEED), state_of(SEED)
            batch = {k: torch.from_numpy(v).to(DEV) for k, v in
                     SyntheticPipeline(cfg, shape).global_batch(0).items()}
            with mesh_context(mesh, M.arch_rules(cfg)):
                psh = M.param_shardings(model, mesh)
                mask = PM.trainable_mask(model.spec, FULL_TRAIN)
                t_specs, _ = PM.partition_params(model.param_specs(), mask)
                t_axes, _ = PM.partition_params(model.param_axes(), mask)
                osh = M.opt_shardings(model, mesh, t_specs, opt_cfg, t_axes)
                zsh = M.zero_grad_shardings(mesh, t_specs, t_axes)
                bsh = M.batch_shardings(mesh, model.batch_spec(shape))
                M.place_train_state(placed, psh, osh)
                mbatch = {k: bsh[k].place(v) for k, v in batch.items()}
                zero_counts()
                placed, m_mesh = make_train_step(
                    model, FULL_TRAIN, opt_cfg, zero_shardings=zsh)(
                    placed, mbatch)
                torch.cuda.synchronize()
                mesh_launches = model_counts()
            plain, m_plain = make_train_step(model, FULL_TRAIN, opt_cfg)(
                plain, batch)
            whole = lambda t: t.full_tensor() if isinstance(t, DTensor) \
                else t
            params = dict(placed.params.named_parameters())
            diff = [n for n, t in plain.params.named_parameters()
                    if not isinstance(params[n], DTensor)
                    or not torch.equal(whole(params[n]), t)]
            diff += [f"{leaf}/{k}" for leaf, st in plain.opt.items()
                     for k, t in st.items()
                     if not isinstance(placed.opt[leaf][k], DTensor)
                     or not torch.equal(whole(placed.opt[leaf][k]), t)]
            loss_equal = float(m_mesh["loss"]) == float(m_plain["loss"])
            if diff or not loss_equal:
                problems.append(f"launch mesh: the ZeRO step differs from "
                                f"the plain step: loss {loss_equal}, "
                                f"leaves {diff[:4]} ({len(diff)})")
            out["step"] = {
                "loss": [float(m_mesh["loss"]), float(m_plain["loss"])],
                "grad_norm": [float(m_mesh["grad_norm"]),
                              float(m_plain["grad_norm"])],
                "leaves_bit_equal": len(params) + sum(
                    len(st) for st in plain.opt.values()) - len(diff),
                "leaves_differing": len(diff), "launches": mesh_launches,
                "placements": sorted({str(t.placements) for t in
                                      placed.params.parameters()})}
            del plain
            # the checkpoint of the placed state, restored onto the mesh
            ck = Checkpointer(os.path.join(d, "ckpt"), keep=1)
            t0 = time.perf_counter()
            ck.save_async(1, placed)
            ck.wait()
            like = M.place_train_state(state_of(SEED + 1), psh, osh)
            step, got = ck.restore_latest(
                like, M.train_state_shardings(like, psh, osh))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            want = dict(placed.params.named_parameters())
            bad = [n for n, t in got.params.named_parameters()
                   if not isinstance(t, DTensor)
                   or t.placements != want[n].placements
                   or not torch.equal(t.full_tensor(),
                                      want[n].full_tensor())]
            bad += [f"{leaf}/{k}" for leaf, st in got.opt.items()
                    for k, t in st.items()
                    if not isinstance(t, DTensor)
                    or t.placements != placed.opt[leaf][k].placements
                    or not torch.equal(t.full_tensor(),
                                       placed.opt[leaf][k].full_tensor())]
            if step != 1 or int(got.step) != 1 or bad:
                problems.append(f"launch mesh: the restore differs at "
                                f"{bad[:4]} ({len(bad)}), step {step}")
            out["restore"] = {"step": step, "leaves_bit_equal": len(want)
                              + sum(len(st) for st in got.opt.values())
                              - len(bad), "leaves_differing": len(bad),
                              "save_and_restore_s": restore_s}
            del placed, got, like
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def launch_phase() -> dict:
    """Phase 9: (a)-(d); one ``launch_train_smollm_360m`` line, then the
    gates.  Returns the launches of (c), the launcher's main path."""
    t_phase = time.perf_counter()
    problems = []
    out = {"check_only": launch_check_only(problems),
           "guard": launch_guard(problems)}
    out["train"], launches, state = launch_smollm(problems)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    out["device_mesh"] = launch_on_device_mesh(problems)
    out["elapsed_s"] = time.perf_counter() - t_phase
    say("launch_train_smollm_360m " + json.dumps(out))
    if problems:
        fail("; ".join(problems))
    return launches


# ---------------------------------------------------------------------------
# phase 8: the measurement grid (the predictor's error on the card)
# ---------------------------------------------------------------------------


def measure_phase() -> dict:
    """Every cell of ``launch.measure.GRID`` through ``measure_grid`` (one
    real step each on the card, the allocator read around it): a
    ``measure`` line per record, each record's prediction held to the
    host's ``planner.check`` for the same cell; the records' store written
    to ``experiments/measured``; then the ``measure_summary`` line, the
    MAPE per arch x kind, family, over the multimodal training cells and
    over all cells — raw under the ``tpu`` and the ``cpu`` term sets,
    calibrated on the even cells and held out on the odd ones, in sample
    as a reading.  Returns the launches the grid made."""
    t_phase = time.perf_counter()
    mismatched, moved, uncounted = [], [], []
    # the allocator's readings of every cell as the runs the store was
    # written from read them: the committed store, which phase 8 does not
    # rewrite
    with open(os.path.join(HERE, "src", "repro_torch", "calibrate",
                           "measured", "h100_80gb_hbm3_700w.json")) as f:
        committed = {(m["arch"], m["meta"]["shape"]): m["measured_bytes"]
                     for m in json.load(f)["measurements"]}

    counted = ME.counted_cells(ME.GRID)

    def on_record(rec):
        cell = ME.MeasureCell(rec["arch"], rec["kind"], rec["seq_len"],
                              rec["global_batch"], rec["policy"],
                              rec["optimizer"], rec["remat"])
        reading = {"measured_peak_bytes": rec["allocator"]["peak_bytes"]}
        if "cost" in rec:
            flops = rec["cost"]["flops_per_device"]
            reading.update({
                "tflop_per_step": flops / 1e12,
                "tflop_per_s": flops / rec["step_s"] / 1e12,
                "share_of_bf16_peak":
                    flops / rec["step_s"] / BF16_OPS_PER_S})
        say("measure " + json.dumps(dict(rec, reading=reading)))
        key = (rec["arch"], rec["shape"])
        if rec["memory"]["total_bytes"] != committed.get(key):
            moved.append((key, rec["memory"]["total_bytes"],
                          committed.get(key)))
        # a counted cell's record has its step's FLOPs, no collective on
        # one card; every record its time
        if ("cost" in rec) != (cell in counted) or not rec["step_s"] > 0 \
                or ("cost" in rec and not (
                    rec["cost"]["flops_per_device"] > 0
                    and rec["loop_aware"]["flops_per_device"]
                    == rec["cost"]["flops_per_device"]
                    and rec["collectives"]["total_wire_bytes_per_device"]
                    == 0)):
            uncounted.append(key)
        want = PL.check(cell.arch, ShapeConfig(cell.shape, cell.seq_len,
                                               cell.global_batch, cell.kind),
                        ME.MESH, policy=SW.POLICIES[cell.policy],
                        optimizer=cell.optimizer, remat=cell.remat,
                        backend=ME.BACKEND, chip=ME.CHIP).peak_bytes
        if rec["predicted"]["peak_bytes"] != want:
            mismatched.append((cell.arch, cell.shape,
                               rec["predicted"]["peak_bytes"], want))

    count_cell, count_s = ME.count_cell, [0.0]

    def timed_count(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return count_cell(*args, **kwargs)
        finally:
            count_s[0] += time.perf_counter() - t0

    zero_counts()
    ME.count_cell = timed_count
    try:
        records = ME.measure_grid(ME.GRID, DEV, on_record=on_record)
    finally:
        ME.count_cell = count_cell
    launches = dict(model_counts(), ssd_scan=SSD.launches)
    # the store first, so that a run the gates below fail leaves its
    # readings
    store = ME.store_of(records)
    path = store.save(measured_dir()
                      / f"{ME.store_name(records[0]['device'])}.json")
    if SF.launches or SC.launches:
        fail("the measurement grid launched a sweep kernel")
    if min(launches.values()) <= 0:
        fail(f"the measurement grid launched a model kernel no time: "
             f"{launches}")
    if mismatched:
        fail(f"records whose prediction is not planner.check's: "
             f"{mismatched[:4]}")
    if moved:
        fail(f"cells whose allocator total moved from the committed "
             f"store's: {moved[:4]}")
    if uncounted:
        fail(f"records without their time, counted cells without their "
             f"step's FLOPs or with collectives on one card, or uncounted "
             f"ones with them: {uncounted[:4]}")
    twin = counter_twin(ME.GRID[0])
    measure_s = time.perf_counter() - t_phase
    summary = ME.summary(store)
    say("measure_summary " + json.dumps({
        "cells": len(records), "archs": len({r["arch"] for r in records}),
        "store": os.path.relpath(path, HERE), "launches": launches,
        "measure_s": measure_s, "counted_steps_s": count_s[0],
        "counter_twin": twin,
        "counted_cells": sum("cost" in r for r in records),
        "flop_per_step": sum(r["cost"]["flops_per_device"]
                             for r in records if "cost" in r),
        "worst_reserved_over_allocated": max(
            r["allocator"]["reserved_over_allocated"] for r in records),
        "alloc_retries": sum(r["allocator"]["alloc_retries"]
                             for r in records),
        **summary, "elapsed_s": time.perf_counter() - t_phase}))
    return launches


# phase 8 reads 56 cells in about 300 s on an H100
MEASURE_TIMEOUT_S = 900


def measure_alone() -> dict:
    """Phase 8 in a process of its own (``--measure-only``), after this
    one's cached blocks are released: its cells meet a caching allocator
    that nothing ran on before them, so each cell's allocator total is the
    cell's own, whatever runs in this process and in which order.  Its
    lines are echoed here (its errors go to this process's); returns its
    launches."""
    gc.collect()
    torch.cuda.empty_cache()
    try:
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--measure-only"], stdout=subprocess.PIPE, text=True,
            env=surface_env(), cwd=HERE, timeout=MEASURE_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        out = e.stdout or b""
        sys.stdout.write(out.decode() if isinstance(out, bytes) else out)
        fail(f"phase 8 did not end within {MEASURE_TIMEOUT_S} s")
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        fail(f"phase 8 exited {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])[
        "measure_launches"]


def counter_twin(cell) -> dict:
    """One step of ``cell`` three times on one state, each between the
    allocator's readings: without a ``StepCounter``, under one, without
    again.  The counter must leave the peak and the kernels' launches as
    they are without it (the second and third steps; the first meets
    cold cuBLAS workspaces)."""
    from repro_torch.core import device_metrics as DM
    model = build_model(get_config(cell.arch))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(ME.SEED)
    gc.collect()
    torch.cuda.empty_cache()
    baseline = DM.allocated_bytes(DEV)
    state = ME.make_state(cell, model, gen, DEV)
    runs = []
    for counted in (False, True, False):
        with mesh_context(ME.MESH):
            run = ME.cell_step(cell, model, state, gen, steps=1)
            zero_counts()
            if counted:
                with DM.StepCounter() as counter:
                    mem, out = DM.memory_stats(run, baseline, DEV)
            else:
                mem, out = DM.memory_stats(run, baseline, DEV)
        runs.append({"peak_bytes": mem.peak_bytes,
                     "launches": model_counts()})
        del run, out
    del state
    gc.collect()
    torch.cuda.empty_cache()
    twin = {"cell": f"{cell.arch} {cell.shape}", "runs": runs,
            "counted_flops": counter.flops,
            "counted_kernel_reports": counter.kernel_launches}
    if runs[1] != runs[2] or counter.kernel_launches != sum(
            runs[1]["launches"].values()):
        fail(f"the step counter moved the step's peak or path: {twin}")
    return twin


# ---------------------------------------------------------------------------
# phase 7: kernel timings at the main path's shapes
# ---------------------------------------------------------------------------


_L2_SCRATCH = []


def flush_l2() -> None:
    """Write 64 MiB, more than the H100's 50 MB L2, so that the next launch
    finds none of its operands in the cache."""
    if not _L2_SCRATCH:
        _L2_SCRATCH.append(torch.empty(64 << 20, dtype=torch.uint8,
                                       device=DEV))
    _L2_SCRATCH[0].fill_(1)


def event_ms(fn, launches: int = 30, warmup: int = 5,
             flush: bool = False) -> float:
    """Median device time of one call, CUDA events around each launch;
    with ``flush`` the L2 is flushed before each timed launch, outside the
    timed interval (for kernels whose operands would otherwise stay in the
    L2 from one launch to the next)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(launches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if flush:
            flush_l2()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def enqueue_ms(fn, calls: int = 30, warmup: int = 5) -> float:
    """Median host time of one call of ``fn`` until it returns (the card
    idle before each): a wrapper's own host work, without its kernel."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def encode_us(q, k, v, do, reps: int = 2000) -> float:
    """Host time of the four ``cuTensorMapEncodeTiled`` calls one bf16 dq
    launch makes, on its padded operands: ``reps`` rounds in one C call,
    over ``reps``."""
    qp, kp, vp, dop, _ = FL.pad_operands(q, k, v, do)
    B, Sq, H, D = qp.shape
    args = (qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(), B,
            Sq, kp.shape[1], H, kp.shape[2], D, vp.shape[3])
    lib = _build.load()
    lib.flash_bwd_dq_wgmma_encode(*args, 10)
    t0 = time.perf_counter()
    rc = lib.flash_bwd_dq_wgmma_encode(*args, reps)
    us = (time.perf_counter() - t0) * 1e6 / reps
    if rc:
        fail(f"flash_bwd_dq_wgmma_encode refused the maps ({rc})")
    return us


def host_ms(fn, calls: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


PROFILE_TRIES = 4


def device_ms(fn, kernel_name: str, launches: int = 20,
              flush: bool = False):
    """Mean device time of the named CUDA kernel over ``launches`` calls of
    ``fn``, from a torch.profiler trace — the kernel alone, without the
    wrapper's host work that the event timing includes; with ``flush`` an
    L2 flush (a kernel of its own) before each call.  None when the
    profiler reports no device time for it (then only the event time is
    known, and the report says "not measured")."""
    return device_ms_by(fn, (kernel_name,), launches, flush)[kernel_name]


def device_ms_by(fn, kernel_names, launches: int = 20,
                 flush: bool = False) -> dict:
    """Mean device time of one launch of each named CUDA kernel over
    ``launches`` calls of ``fn`` (each after an L2 flush with ``flush``),
    from one torch.profiler trace.  A trace that lacks one of them is
    taken again, up to PROFILE_TRIES traces: the profiler misses a kernel
    now and then (about half the first traces of phase 7 in one run, one
    entry in two traces running; PERF.md § 6).  A name no trace shows
    maps to None."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    found = {}
    for _ in range(PROFILE_TRIES):
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(launches):
                    if flush:
                        flush_l2()
                    fn()
                torch.cuda.synchronize()
        except RuntimeError as e:       # no device tracing on this machine
            print(f"chip_smoke: profiler unavailable ({e})", file=sys.stderr)
            break
        for ev in prof.key_averages():
            for name in kernel_names:
                if name in ev.key and name not in found:
                    total_us = getattr(ev, "device_time_total", None)
                    if total_us is None:
                        total_us = getattr(ev, "cuda_time_total", 0)
                    if total_us and ev.count:
                        found[name] = total_us / ev.count / 1e3
        if len(found) == len(kernel_names):
            break
        print(f"chip_smoke: the profiler's trace lacks "
              f"{sorted(set(kernel_names) - set(found))}", file=sys.stderr)
    return {name: found.get(name) for name in kernel_names}


def shard_factor_work(p: "SF.Packed") -> tuple:
    """Bytes and operations of the function on ``p``'s requests: what it
    needs read once — the compact operand values (dims and sizes) and each
    request's program (its descriptors, header and steps) — and 8 bytes
    written per cell; nothing of the kernel's own derived buffers
    (inverses, tiles); 4 int64 operations (the function's multiply,
    remainder, compare, select) per step and cell."""
    n_bytes = 8 * (p.operands.size + p.rows.size + p.requests.size
                   + p.steps.size + p.n_out)
    n_ops = 4 * int((p.requests[:, SF.REQ_STEPS]
                     * p.requests[:, SF.REQ_N]).sum())
    return n_bytes, n_ops


def _sf_timing(packed: "SF.Packed", what: str) -> dict:
    """The kernel on one packed build: CUDA events (L2 flushed), the
    kernel alone (profiler), the wrapper's own host time until it returns
    (``host_call_us``), the path a table build takes — the packed host
    buffers up in one copy from pinned memory, one launch, one read-back
    (``host_roundtrip_ms``, host clock, synchronised) — the plain version
    and the bound."""
    dev = packed.to(DEV)
    n_bytes, n_ops = shard_factor_work(packed)
    bound_ms, bound_by = _bound(n_bytes, n_ops, ALU_OPS_PER_S)
    return {
        "ms": event_ms(lambda: SF.shard_factor_batch(dev), flush=True),
        "device_ms": device_ms(lambda: SF.shard_factor_batch(dev),
                               "shard_factor_batch_kernel", flush=True),
        "host_call_us": enqueue_ms(lambda: SF.shard_factor_batch(dev))
        * 1e3,
        "host_roundtrip_ms": host_ms(
            lambda: SF.shard_factor_batch(packed.to(DEV)).cpu()),
        "plain_ms": event_ms(lambda: SF.shard_factor_batch_plain(dev),
                             flush=True),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": {"build": what, "requests": len(packed.requests),
                  "cells": packed.n_out, "operands": packed.operands.size,
                  "steps": len(packed.steps),
                  "step_cells": int((packed.requests[:, SF.REQ_STEPS]
                                     * packed.requests[:, SF.REQ_N]).sum()),
                  "tiles": len(packed.tiles)},
        "bytes": n_bytes, "operations": n_ops,
        "l2": "flushed before each timed launch"}


def time_kernels(log: ShapeLog, checks: dict, launches: dict) -> list:
    # the kernels once more against their plain versions, now on the very
    # operands the sweeps handed them
    packed = log.sf
    dev = packed.to(DEV)
    deltas = log.sc.to(DEV)
    for name, got, want in (
            ("shard_factor", SF.shard_factor_batch(dev),
             SF.shard_factor_batch_plain(dev)),
            ("segmented_cummax", SC.segmented_cummax(deltas),
             SC.segmented_cummax_plain(deltas))):
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], err)
        if err:
            fail(f"{name} kernel != plain version on the sweep's own "
                 f"operands (max abs diff {err})")
    sf = {
        "name": "shard_factor", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/shard_factor.cu",
        "replaces": "src/repro/kernels/shard_factor.py:131",
        "launches": launches["shard_factor"],
        "max_abs_err": checks["shard_factor"]["max_abs_err"],
        "design": check_sf_build(),
        **_sf_timing(packed, "the sweeps' largest table build"),
        "library_ms": None,
    }
    small = log.sf_small
    if small is None:
        fail("shard_factor: the searches handed the wrapper no build")
    dev_small = small.to(DEV)
    err = int((SF.shard_factor_batch(dev_small)
               - SF.shard_factor_batch_plain(dev_small)).abs().max())
    if err:
        fail(f"shard_factor kernel != plain version on the searches' "
             f"first build (max abs diff {err})")
    sf["other_shapes"] = [{**_sf_timing(small, "the searches' first (cold) "
                                        "table build"),
                           "library_ms": None}]

    n_events, m = deltas.shape
    sc_bytes = (n_events + 1) * 8 * m
    sc_ops = 2 * n_events * m            # add + max per element
    sc_bound = max(sc_bytes / HBM_BYTES_PER_S, sc_ops / ALU_OPS_PER_S)
    sc = {
        "name": "segmented_cummax", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segmented_cummax.cu",
        "replaces": "src/repro/kernels/segmented_cummax.py:63",
        "launches": launches["segmented_cummax"],
        "max_abs_err": checks["segmented_cummax"]["max_abs_err"],
        "ms": event_ms(lambda: SC.segmented_cummax(deltas), flush=True),
        "plain_ms": event_ms(lambda: SC.segmented_cummax_plain(deltas),
                             flush=True),
        "bound_ms": sc_bound * 1e3,
        "bound_by": "bytes" if sc_bytes / HBM_BYTES_PER_S
        >= sc_ops / ALU_OPS_PER_S else "operations",
        "library_ms": None,
        "device_ms": device_ms(lambda: SC.segmented_cummax(deltas),
                               "segmented_cummax_kernel", flush=True),
        "l2": "flushed before each timed launch",
        "shape": {"n_events": n_events, "n": m},
    }
    for k in (sf, sc):
        if not (k["ms"] > 0 and k["plain_ms"] > 0 and k["bound_ms"] > 0):
            fail(f"{k['name']}: a timing came back non-positive")
    return [sf, sc]


def _bound(n_bytes: float, n_ops: float, ops_per_s: float) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def sdpa_backend(fn) -> str:
    """Which of PyTorch's attention backends ``fn`` (one SDPA call, or its
    backward) ran: the name of the ``aten::_scaled_dot_product_*`` op the
    profiler saw ("math" where none ran)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {ev.key for ev in prof.key_averages()}
    for kind in ("flash", "efficient", "cudnn"):
        if any(f"_scaled_dot_product_{kind}_attention" in n for n in names):
            return kind
    return "math"


def _attention_inputs(shape: tuple, gen, n: int = 3) -> tuple:
    """bf16 q, k, v (and ``n`` > 3: dout) of a ``(B, S, H, D[, Dv])``
    timing shape; v and dout at Dv (default D)."""
    b, sq, h, d = shape[:4]
    dv = shape[4] if len(shape) > 4 else d
    return tuple(torch.randn(b, sq, h, w, generator=gen, device=DEV)
                 .to(torch.bfloat16) for w in (d, d, dv, dv)[:n])


def _shape_row(shape: tuple, causal: bool) -> dict:
    b, sq, h, d = shape[:4]
    dv = shape[4] if len(shape) > 4 else d
    return {"B": b, "S": sq, "H": h, "D": d, "Dv": dv, "causal": causal,
            "dtype": "bfloat16", "instance": list(FL.instance_for(d, dv))}


def _flash_timing(shape: tuple, causal: bool, gen) -> dict:
    """The forward at ``(B, S, H, D[, Dv])``: q . k products at D and P . v
    at Dv, 2 x scores x (D + Dv) operations; q, k read at D, v read and
    out written at Dv, the fp32 lse written."""
    b, sq, h, d = shape[:4]
    q, k, v = _attention_inputs(shape, gen)
    dv = v.shape[-1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    scores = b * h * sq * sq * (0.5 if causal else 1.0)
    n_ops = 2 * scores * (d + dv)
    n_bytes = 2 * (q.numel() + v.numel()) * q.element_size() + 4 * b * h * sq
    bound_ms, bound_by = _bound(n_bytes, n_ops, BF16_OPS_PER_S)
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=causal)
    di, dvi = FL.instance_for(d, dv)
    return {
        "shape": _shape_row(shape, causal),
        # the instance's products over the true shape's (zero columns)
        "padded_ops_over_true": (di + dvi) / (d + dv),
        "ms": event_ms(lambda: FL.flash_fwd(q, k, v, causal=causal),
                      flush=True),
        "host_call_us": enqueue_ms(
            lambda: FL.flash_fwd(q, k, v, causal=causal)) * 1e3,
        "device_ms": device_ms(
            lambda: FL.flash_fwd(q, k, v, causal=causal),
            FLASH_KERNEL["fwd"], flush=True),
        "plain_ms": event_ms(
            lambda: FL.flash_fwd_plain(q, k, v, causal=causal), launches=10,
            flush=True),
        "library_ms": event_ms(library, flush=True),
        "library_backend": sdpa_backend(library),
        "l2": "flushed before each timed launch",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "flops": n_ops, "bytes": n_bytes}


def _rmsnorm_timing(shape: tuple, gen) -> dict:
    x = torch.randn(shape, generator=gen, device=DEV).to(torch.bfloat16)
    sc = torch.randn(shape[-1:], generator=gen, device=DEV) \
        .to(torch.bfloat16)
    n_bytes = (2 * x.numel() + sc.numel()) * x.element_size()
    bound_ms, bound_by = _bound(n_bytes, 5 * x.numel(), ALU_OPS_PER_S)
    return {
        "shape": {"rows": x.numel() // shape[-1], "D": shape[-1],
                  "dtype": "bfloat16"},
        "ms": event_ms(lambda: RN.rmsnorm_fwd(x, sc), flush=True),
        "device_ms": device_ms(lambda: RN.rmsnorm_fwd(x, sc),
                               "rmsnorm_fwd_kernel", flush=True),
        "plain_ms": event_ms(lambda: RN.rmsnorm_fwd_plain(x, sc), flush=True),
        "library_ms": event_ms(lambda: F.rms_norm(x, shape[-1:], sc, 1e-5),
                               flush=True),
        "l2": "flushed before each timed launch",
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes}


def _flash_bwd_timing(shape: tuple, causal: bool, gen) -> tuple:
    """The dq and the dk / dv pass at one shape, each with its own bound;
    the plain version and the library call compute all three gradients,
    so those two times stand in both rows.  Products at D (s = q k^T, dq,
    dk) and at Dv (dp = dout v^T, dv): the dq pass does 2 x scores x (2D
    + Dv) operations, the dk / dv pass 2 x scores x (2D + 2Dv); each
    tensor is counted at its own width."""
    b, sq, h, d = shape[:4]
    q, k, v, do = _attention_inputs(shape, gen, 4)
    dv = v.shape[-1]
    out, lse = FL.flash_fwd(q, k, v, causal=causal)
    _, delta = FL.flash_bwd_dq(q, k, v, out, lse, do, causal=causal)
    plain_ms = event_ms(lambda: FL.flash_bwd_plain(q, k, v, out, lse, do,
                                                   causal=causal),
                        launches=10, flush=True)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    library = lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                          retain_graph=True)
    library_ms = event_ms(library, flush=True)
    backend = sdpa_backend(library)
    scores = b * h * sq * sq * (0.5 if causal else 1.0)
    t_d = q.numel() * q.element_size()          # a tensor at D
    t_dv = v.numel() * v.element_size()         # a tensor at Dv
    stat = 4 * b * h * sq
    di, dvi = FL.instance_for(d, dv)
    rows = []
    for name, width, padded, n_bytes, fn, kern in (
            # dq pass: s, dp and dq; reads q k v out dout lse, writes dq
            # and delta
            ("flash_dq", 2 * d + dv, 2 * di + dvi,
             3 * t_d + 3 * t_dv + 2 * stat,
             lambda: FL.flash_bwd_dq(q, k, v, out, lse, do, causal=causal),
             "dq"),
            # dk / dv pass: s, dp, dv and dk; reads q k v dout lse delta,
            # writes dk dv
            ("flash_dkv", 2 * d + 2 * dv, 2 * di + 2 * dvi,
             3 * t_d + 3 * t_dv + 2 * stat,
             lambda: FL.flash_bwd_dkv(q, k, v, lse, do, delta,
                                      causal=causal),
             "dkv")):
        n_ops = 2 * scores * width
        bound_ms, bound_by = _bound(n_bytes, n_ops, BF16_OPS_PER_S)
        rows.append({
            "shape": _shape_row(shape, causal),
            "padded_ops_over_true": padded / width,
            "ms": event_ms(fn, flush=True),
            "host_call_us": enqueue_ms(fn) * 1e3,
            "device_ms": device_ms(fn, FLASH_KERNEL[kern], flush=True),
            "l2": "flushed before each timed launch",
            "plain_ms": plain_ms, "plain_covers": "dq, dk and dv",
            "library_ms": library_ms,
            "library_covers": "dq, dk and dv (SDPA backward)",
            "library_backend": backend,
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": n_ops,
            "bytes": n_bytes})
    rows[0]["encode_us"] = encode_us(q, k, v, do)
    return rows[0], rows[1]


def _rmsnorm_bwd_timing(shape: tuple, gen) -> dict:
    x, dy = (torch.randn(shape, generator=gen, device=DEV)
             .to(torch.bfloat16) for _ in range(2))
    sc = torch.randn(shape[-1:], generator=gen, device=DEV) \
        .to(torch.bfloat16)
    # x and dy read, dx written, scale read and dscale written once
    n_bytes = (3 * x.numel() + 2 * sc.numel()) * x.element_size()
    bound_ms, bound_by = _bound(n_bytes, 10 * x.numel(), ALU_OPS_PER_S)
    xr, sr = x.detach().requires_grad_(), sc.detach().requires_grad_()
    y = F.rms_norm(xr, shape[-1:], sr, 1e-5)
    return {
        "shape": {"rows": x.numel() // shape[-1], "D": shape[-1],
                  "dtype": "bfloat16"},
        "ms": event_ms(lambda: RN.rmsnorm_bwd(x, sc, dy), flush=True),
        "device_ms": device_ms(lambda: RN.rmsnorm_bwd(x, sc, dy),
                               "rmsnorm_bwd_kernel", flush=True),
        "plain_ms": event_ms(lambda: RN.rmsnorm_bwd_plain(x, sc, dy),
                             flush=True),
        "library_ms": event_ms(lambda: torch.autograd.grad(
            y, (xr, sr), dy, retain_graph=True), flush=True),
        "l2": "flushed before each timed launch",
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes}


def time_model_kernels(checks: dict, launches: dict) -> list:
    """The five model kernels at the largest shape the main path gave each
    (the training path's: LM attention (8, 2,048, 32, 128) causal, 16,384
    RMSNorm rows of 4,096), the entry's own numbers; the other shapes the
    main path gives them (the ViT's, serving's) under ``other_shapes``."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 2)
    cfg = get_config(SERVE_ARCH)
    v = cfg.vlm
    n_patch = (v.vit_image_size // v.vit_patch) ** 2
    S_serve = n_patch + SERVE_TEXT
    S_train = TRAIN_TEXT + v.n_image_tokens
    hd = cfg.resolved_head_dim
    lm_shape = (TRAIN_BATCH, S_train, cfg.n_heads, hd)
    vit_heads = (v.vit_heads, v.d_vision // v.vit_heads)
    b, sq, _, h, _, d, _, _ = TRAIN_LM_CASE
    if lm_shape != (b, sq, h, d) or TRAIN_ROWS != (TRAIN_BATCH * S_train,
                                                   cfg.d_model):
        fail("the checked training shapes are not the training path's")
    fwd_main = _flash_timing(lm_shape, True, gen)
    fwd_other = [_flash_timing((TRAIN_BATCH, n_patch + 1) + vit_heads,
                               False, gen),
                 _flash_timing((SERVE_BATCH, S_serve, cfg.n_heads, hd),
                               True, gen),
                 _flash_timing((SERVE_BATCH, n_patch + 1) + vit_heads,
                               False, gen)]
    # the enc-dec's attention: the encoder's (and the cross-attention's),
    # non-causal, and the decoder's causal self-attention, 4 x 2,048
    ecfg = get_config(ENCDEC_ARCH)
    e_shape = (ENCDEC_BATCH, ENCDEC_PROMPT, ecfg.n_heads,
               ecfg.resolved_head_dim)
    fwd_other += [_flash_timing(e_shape, False, gen),
                  _flash_timing(e_shape, True, gen)]
    # the MLA and hybrid pairs: deepseek-v2-lite-16b's prefill, minicpm3-4b's
    # prefill and training, zamba2-2.7b's shared attention
    for shape in ((4, 2048, 16, 192, 128), (4, 2048, 40, 96, 64),
                  (4, 2048, 32, 80)):
        fwd_other.append(_flash_timing(shape, True, gen))
    # the (256, 256) instance at 4 x 2,048, 16 heads, and the reduced MLA
    # archs' (24, 16), padded to (32, 32), as their card runs give it
    for shape in WIDE_TIMED:
        fwd_other.append(_flash_timing(shape, True, gen))
    dq, dkv = _flash_bwd_timing(lm_shape, True, gen)
    # the pairs' backward: minicpm3-4b's and zamba2-2.7b's training, and
    # deepseek-v2-lite-16b's (192, 128) at its prefill shape (no path
    # trains deepseek: its training does not fit one card)
    bwd_other = [_flash_bwd_timing(shape, True, gen)
                 for shape in ((4, 2048, 40, 96, 64), (4, 2048, 32, 80),
                               (4, 2048, 16, 192, 128), *WIDE_TIMED)]
    # and the (64, 64) pair of seamless-m4t-large-v2's training (its
    # encoder and cross-attention non-causal, its decoder causal) and of
    # phase 9's smollm-360m
    bwd_other += [_flash_bwd_timing(e_shape, c, gen) for c in (False, True)]
    rn_main = _rmsnorm_timing((TRAIN_BATCH * S_train, cfg.d_model), gen)
    rn_other = [_rmsnorm_timing((SERVE_BATCH * S_serve, cfg.d_model), gen),
                _rmsnorm_timing((SERVE_BATCH, 1, cfg.d_model), gen),
                _rmsnorm_timing((MAMBA_BATCH * MAMBA_PROMPT, 4096), gen),
                _rmsnorm_timing((ENCDEC_BATCH * ENCDEC_PROMPT, 1024), gen),
                # zamba2-2.7b: block and shared norms, and the gated norm
                # over d_inner, 4 x 2,048 rows
                _rmsnorm_timing((HYBRID_BATCH * HYBRID_PROMPT, 2560), gen),
                _rmsnorm_timing((HYBRID_BATCH * HYBRID_PROMPT, 5120), gen)]
    rn_bwd = _rmsnorm_bwd_timing((TRAIN_BATCH * S_train, cfg.d_model), gen)
    # and past the shared-memory partial row: 8,192 rows of 16,384
    rn_bwd_other = [_rmsnorm_bwd_timing((HYBRID_TRAIN_BATCH * HYBRID_PROMPT,
                                         d), gen) for d in (2560, 5120,
                                                            16384)]
    out = []
    # per kernel: its check, the outputs of that check that are its own,
    # and the checked shape it is timed at
    for name, src, repl, check, mine, case, main, others in (
            ("flash_fwd", "flash_attention_wgmma.cu",
             "src/repro/kernels/flash_attention.py:45", "flash_fwd",
             ("out", "lse"), TRAIN_LM_CASE, fwd_main, fwd_other),
            ("flash_dq", "flash_attention_bwd_wgmma.cu",
             "src/repro/kernels/flash_attention.py:165", "flash_bwd",
             ("dq",), TRAIN_LM_CASE, dq, [r[0] for r in bwd_other]),
            ("flash_dkv", "flash_attention_bwd_wgmma.cu",
             "src/repro/kernels/flash_attention.py:212", "flash_bwd",
             ("dk", "dv"), TRAIN_LM_CASE, dkv, [r[1] for r in bwd_other]),
            ("rmsnorm_fwd", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:20",
             "rmsnorm_fwd", ("float32", "bfloat16"), TRAIN_ROWS, rn_main,
             rn_other),
            ("rmsnorm_bwd", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:28",
             "rmsnorm_bwd", ("dx", "dscale"), TRAIN_ROWS, rn_bwd,
             rn_bwd_other)):
        c = checks[check]

        def own(errs):
            return {k: e for k, e in errs.items() if k.split("_")[0] in mine}
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{src}",
                 "replaces": repl, "launches": launches[name],
                 "max_abs_err": max(own(c["max_abs_err_by"]).values()),
                 "max_abs_err_at_shape": own(
                     c["max_abs_err_by_case"][case_key(case)])}
        entry.update(main)
        if name in MMA_KERNELS:
            entry["tensor_cores"] = flash_design(MMA_KERNELS[name], d, d)
        entry["other_shapes"] = others
        if name in MMA_KERNELS:
            for o in others:        # each shape's own instance
                di, dvi = o["shape"]["instance"]
                o["tensor_cores"] = flash_design(MMA_KERNELS[name], di, dvi)
        for k in [entry] + others:
            if not (k["ms"] > 0 and k["plain_ms"] > 0 and k["bound_ms"] > 0
                    and k["library_ms"] > 0):
                fail(f"{name}: a timing came back non-positive")
        out.append(entry)
    return out


# the flash shapes phase 7 adds for the widened kernels: the (256, 256)
# instance at 4 x 2,048, 16 heads; the reduced MLA pair (24, 16) at the
# reduced archs' card-vs-CPU shape (2 x 40 tokens, 4 heads)
WIDE_TIMED = ((4, 2048, 16, 256, 256), (2, 40, 4, 24, 16))


def with_ratios(k: dict) -> dict:
    """``share_of_bound`` = bound / the kernel alone on the device and
    ``vs_library`` = the kernel alone / the library call (None where a
    time is missing), on the entry and its other shapes."""
    for e in [k] + k.get("other_shapes", []):
        dev, lib = e["device_ms"], e.get("library_ms")
        e["share_of_bound"] = e["bound_ms"] / dev if dev else None
        e["vs_library"] = dev / lib if dev and lib else None
        if "host_call_us" in e:
            e["wrapper_minus_kernel_us"] = \
                (e["ms"] - dev) * 1e3 if dev else None
    return k


def ssd_work(case) -> tuple:
    """(operations, bytes) of one SSD call, as the function needs them:
    per (b, chunk) the lower triangle of C B^T (Q(Q+1)/2 dot products of
    length N), which all heads share (G = 1); per (b, h, chunk) its
    masked product with x dt (Q(Q+1)/2 x P multiply-adds), C state^T and
    the state update (4QNP); over the chunks the data has, the ragged
    last one at its own length; x, y, B, C in bf16, dt, A and the final
    state in fp32, each read or written once."""
    b, S, H, P, N, chunk = case
    qs = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    n_ops = b * sum(q * (q + 1) * N + H * (q * (q + 1) * P + 4 * q * N * P)
                    for q in qs)
    n_bytes = 2 * (2 * b * S * H * P + 2 * b * S * N) + 4 * (
        b * S * H + H + b * H * P * N)
    return n_ops, n_bytes


# the widened SSD's timed shapes (checked in phase 2's WIDE_SSD_CASES)
SSD_SLAB_CASE = (4, 2048, 16, 256, 128, 256)
SSD_WALK_CASE = (4, 2048, 64, 16, 512, 256)


def ssd_device_ms(fn, plan) -> dict:
    """The bf16 SSD's kernels alone on the device for one call of ``fn``:
    each kernel's mean launch (profiler) times the plan's programs (each
    launches both), and their sum as ``device_ms`` (None where the
    profiler misses one)."""
    per_launch = device_ms_by(fn, SSD_KERNELS)
    kernels = {k: None if per_launch.get(k) is None
               else per_launch[k] * plan.launches for k in SSD_KERNELS}
    total = None if None in kernels.values() else sum(kernels.values())
    return {"device_ms": total, "kernel_ms": kernels}


def ssd_design(P: int, N: int, chunk: int, dtype=torch.bfloat16) -> dict:
    """The bf16 SSD's design at (P, N, chunk): its kernels with their
    threads and ptxas lines, shared memory per block, heads per scan block
    and ring slots."""
    res = mma_resources()
    smem = SSD.wgmma_smem(P, N, chunk)
    return {"design": "wgmma",
            "kernels": {k: {"threads": SSD_THREADS[k],
                            "ptxas": res.get(f"{k}<{P}>")}
                        for k in SSD_KERNELS},
            "heads_per_scan_block": smem["heads"],
            "ring_slots": {"b": smem["b_slots"], "x": smem["x_slots"]}}


def _ssd_timing(case, c: dict, gen) -> dict:
    """One SSD shape in bf16 for ``other_shapes``: wrapper call, the
    kernels alone (their sum per call), the plain version, the bound; the
    plan's slabs and pieces."""
    args = ssd_inputs(case, gen, torch.bfloat16)
    b, S, H, P, N, chunk = case
    plan = SSD.kernel_plan(P, N, torch.bfloat16)
    n_ops, n_bytes = ssd_work(case)
    bound_ms, bound_by = _bound(n_bytes, n_ops, BF16_OPS_PER_S)
    return {
        "shape": {"b": b, "S": S, "H": H, "P": P, "N": N, "chunk": chunk,
                  "dtype": "bfloat16"},
        "plan": {"slabs": plan.slabs, "pieces": plan.pieces,
                 "launches_per_call": plan.launches},
        "max_abs_err_at_shape": c["max_abs_err_by_case"][case_key(case)],
        "ms": event_ms(lambda: SSD.ssd_scan(*args, chunk=chunk)),
        **ssd_device_ms(lambda: SSD.ssd_scan(*args, chunk=chunk), plan),
        "plain_ms": event_ms(lambda: SSD.ssd_scan_plain(*args, chunk=chunk),
                             launches=10),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        "flops": n_ops, "bytes": n_bytes,
        "smem_bytes_per_block": {
            k: v for k, v in SSD.wgmma_smem(
                max(w for _, w, _ in plan.slabs), plan.N, chunk).items()
            if k in ("state", "scan")}}


def time_ssd(checks: dict, launches: dict) -> dict:
    """The SSD at the serving path's prefill shape, bf16 (the state pass
    and the chunk scan on wgmma): the wrapper call (CUDA events, median of
    30), the kernels alone (profiler, by their own names: each one's time
    and their sum), the plain version; no single PyTorch call computes the
    SSD scan.  zamba2-2.7b's prefill shape, P 256 in slabs and N 512
    under ``other_shapes``."""
    cfg = get_config(MAMBA_ARCH)
    case = (MAMBA_BATCH, MAMBA_PROMPT, cfg.ssm.n_heads(cfg.d_model),
            cfg.ssm.head_dim, cfg.ssm.d_state, cfg.ssm.chunk)
    if case != SERVE_SSD_CASE:
        fail(f"the checked SSD shape {SERVE_SSD_CASE} is not the serving "
             f"path's {case}")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 6)
    args = ssd_inputs(case, gen, torch.bfloat16)
    n_ops, n_bytes = ssd_work(case)
    bound_ms, bound_by = _bound(n_bytes, n_ops, BF16_OPS_PER_S)
    c = checks["ssd_scan"]
    b, S, H, P, N, chunk = case
    plan = SSD.kernel_plan(P, N, torch.bfloat16)
    smem = SSD.wgmma_smem(P, N, chunk)
    entry = {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_wgmma.cu",
        "replaces": "src/repro/kernels/ssd.py:25",
        "launches": launches["ssd_scan"],
        "max_abs_err": c["max_abs_err"],
        "max_abs_err_at_shape": c["max_abs_err_by_case"][case_key(case)],
        "shape": {"b": b, "S": S, "H": H, "P": P, "N": N, "chunk": chunk,
                  "dtype": "bfloat16"},
        "ms": event_ms(lambda: SSD.ssd_scan(*args, chunk=chunk)),
        **ssd_device_ms(lambda: SSD.ssd_scan(*args, chunk=chunk), plan),
        "plain_ms": event_ms(lambda: SSD.ssd_scan_plain(*args, chunk=chunk),
                             launches=10),
        "library_ms": None, "library": "none exists",
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": n_ops,
        "bytes": n_bytes,
        "grid_blocks": SSD.grid_blocks(plan, b, S, H, chunk, torch.bfloat16),
        "sms": torch.cuda.get_device_properties(DEV).multi_processor_count,
        "smem_bytes_per_block": {k: smem[k] for k in ("state", "scan")},
        "tensor_cores": ssd_design(P, N, chunk)}
    # zamba2-2.7b's prefill shape; P 256 as two slabs of one launch; N
    # 512 in one launch
    entry["other_shapes"] = [_ssd_timing(case, c, gen)
                             for case in (ZAMBA2_SSD_CASE, SSD_SLAB_CASE,
                                          SSD_WALK_CASE)]
    for e in [entry] + entry["other_shapes"]:
        if not (e["ms"] > 0 and e["plain_ms"] > 0 and e["bound_ms"] > 0):
            fail("ssd_scan: a timing came back non-positive")
    return entry


def say_kernel(k: dict) -> None:
    dev = "not measured" if k["device_ms"] is None \
        else f"{k['device_ms'] * 1e3:.1f} us"
    share = "" if k["share_of_bound"] is None \
        else f", {100 * k['share_of_bound']:.1f} % of the bound"
    lib = "" if k["vs_library"] is None \
        else f", {k['vs_library']:.2f}x the library call"
    design = k.get("tensor_cores", k.get("design", {})).get("design")
    design = f" ({design} design)" if design else ""
    say(f"kernel {k['name']}{design}: {k['ms'] * 1e3:.1f} us/call by CUDA "
        f"events (kernel alone on the device: {dev}; plain "
        f"{k['plain_ms'] * 1e3:.1f} us, bound "
        f"{k['bound_ms'] * 1e3:.3f} us by {k['bound_by']}{share}{lib}) at "
        f"{k['shape']}, {k['launches']} launches on the main path")


# ---------------------------------------------------------------------------


def main(argv: list) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="On-card smoke test of the "
                                 "PyTorch/CUDA port.")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, check every kernel against its plain "
                    "version (phase 2) and time the model kernels at the "
                    "main path's shapes, without driving the main path; "
                    "prints no result line")
    ap.add_argument("--measure-only", action="store_true",
                    help="phase 8 alone in this process, its launches as "
                    "the last line (the full run starts it so, in a "
                    "process of its own)")
    args = ap.parse_args(argv)
    if args.measure_only:
        _build.load()
        say(json.dumps({"measure_launches": measure_phase()}))
        return 0
    t_start = time.perf_counter()
    # phase 1: toolchain, card, build
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    nvcc = run_text([_build._find_nvcc(), "--version"]).splitlines()[-2:]
    say(f"toolchain: python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} numpy "
        f"{np.__version__} | {' '.join(nvcc)}")
    say(f"card: {smi}")
    _build.load()
    say(f"build: {len(_build.sources())} CUDA sources in "
        f"{_build.build_seconds:.1f} s (set-up; "
        f"{'cold nvcc, in parallel' if _build.build_seconds else 'cached'})"
        f" -> {_build.build_dir()}")
    resources = mma_resources()
    say("ptxas " + json.dumps(resources))
    spills = [k for k, r in resources.items()
              if r.get("spill_store_bytes") or r.get("spill_load_bytes")]
    if spills or not resources:
        print(f"chip_smoke: the tensor-core kernels spill registers or "
              f"ptxas reported nothing: {spills}", file=sys.stderr)
    say("wgmma_build " + json.dumps(check_wgmma_build()))
    say("sf_build " + json.dumps(check_sf_build()))

    t_phase = [t_start]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        say(f"elapsed {name}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    phase_done("1 toolchain and build")
    # phase 2: kernels against their plain versions
    checks = {}
    for check in (check_shard_factor, check_segmented_cummax, check_flash,
                  check_rmsnorm, check_flash_bwd, check_rmsnorm_bwd,
                  check_ssd):
        c = check()
        checks[c["name"]] = c
    say("kernels_check " + json.dumps(list(checks.values())))
    phase_done("2 kernels_check")
    if not args.kernels_only:
        # phase 8: the measurement grid, in a process of its own
        measure_launches = measure_alone()
        phase_done("8 measure")
    if args.kernels_only:
        for k in time_model_kernels(checks, {n: None for n in model_counts()}) \
                + [time_ssd(checks, {"ssd_scan": None})]:
            say_kernel(with_ratios(k))
        say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
        return 0

    # phases 3-4: the main path
    gc.collect()
    before_sweeps = torch.cuda.memory_allocated()
    log = ShapeLog()
    sweeps = [run_sweep("sweep_large_legacy", large_grid("legacy"),
                        124416, log),
              run_sweep("sweep_large_liveness", large_grid("liveness"),
                        124416, log),
              run_sweep("sweep_pipe_liveness", pipe_grid(), 1959552, log),
              # phases 4b-4c: the five archs added last, with the expert
              # and context mesh axes
              run_sweep("sweep_moe_epcp", moe_epcp_grid(), 1377792, log,
                        want=MOE_EPCP_WANT,
                        cover=(("expert > 1", lambda m: m["expert"] > 1),
                               ("context > 1", lambda m: m["context"] > 1))),
              run_sweep("sweep_new_archs", new_archs_grid(), 539136, log,
                        want=NEW_ARCHS_WANT,
                        cover=(("context > 1",
                                lambda m: m["context"] > 1),))]
    # phase 4d: the planner's search queries
    with log.first_build():
        searches = [run_searches()]
    # phase 4e: calibration fitted on the host; 4f: the calibrated sweeps,
    # each followed by the same engine under the goldens' profile
    profiles = run_calibrate()
    sweeps += run_calibrated("sweep_calibrated_legacy",
                             dataclasses.replace(large_grid("legacy"),
                                                 profile=profiles["legacy"]),
                             124416, log, CAL_LEGACY_WANT, GOLDEN_LEGACY_WANT)
    sweeps += run_calibrated("sweep_calibrated_pipe",
                             dataclasses.replace(
                                 pipe_grid(), profile=profiles["liveness"]),
                             1959552, log, CAL_PIPE_WANT, GOLDEN_PIPE_WANT)
    # phase 4g: the serving fleet, request mixes and drafts, both
    # assemblies
    sweeps += [run_sweep(f"sweep_fleet_{asm}", fleet_grid(asm), FLEET_CELLS,
                         log, want=FLEET_WANT[asm])
               for asm in ("legacy", "liveness")]
    # phase 4h: the searches under the fitted profile and under a mix
    searches.append(run_calibrated_searches(profiles["legacy"]))
    launches = {k: sum(s["launches"][k] for s in sweeps)
                + sum(q[k] for q in searches)
                for k in ("shard_factor", "segmented_cummax")}

    # phase 5: serving (the sweeps' device state is gone with their
    # engines and the shape log goes to the host; release the cached
    # blocks before the 7B weights).  What the sweeps leave allocated is
    # in every later phase's allocator peak: printed, so a moved peak can
    # be held to it
    log.to_host()
    gc.collect()
    torch.cuda.empty_cache()
    say("sweep_resident " + json.dumps({
        "allocated_before_sweeps_bytes": before_sweeps,
        "allocated_after_sweeps_bytes": torch.cuda.memory_allocated(),
        "left_by_sweeps_bytes": torch.cuda.memory_allocated()
        - before_sweeps}))
    phase_done("3-4h sweeps, searches, calibration")
    serve = serve_llava15_7b()
    launches.update({k: 0 for k in model_counts()})
    launches.update(serve["launches"]["generate"])

    phase_done("5 serve_llava15_7b")

    # phase 5b: serving mamba2-1.3b
    mamba = serve_mamba2_1_3b()
    launches["rmsnorm_fwd"] += mamba["launches"]["generate"]["rmsnorm_fwd"]
    launches["ssd_scan"] = mamba["launches"]["generate"]["ssd_scan"]
    phase_done("5b serve_mamba2_1_3b")

    # phase 5c: serving the enc-dec seamless-m4t-large-v2
    encdec = serve_seamless_m4t_large_v2()
    for k, n in encdec["launches"]["generate"].items():
        launches[k] += n
    phase_done("5c serve_seamless_m4t_large_v2")

    # phase 5d: serving the MoE arctic-480b at full width, depth 2
    for k, n in serve_arctic_480b_2l()["launches"]["generate"].items():
        launches[k] += n
    phase_done("5d serve_arctic_480b_2l")

    # phase 6: training, stage 1 at full size, stage 2 with 8 LM blocks,
    # then stage 2's Adafactor and 8-bit Adam steps
    for phase in train_llava15_7b():
        for k, n in phase["launches_total"].items():
            launches[k] += n
    train_optimizers()
    phase_done("6 train_llava15_7b")

    # phase 6c: training the enc-dec
    for k, n in train_seamless_m4t_large_v2()["launches_total"].items():
        launches[k] += n
    phase_done("6c train_seamless_m4t_large_v2")

    # phase 6d: training mamba2-1.3b at full size
    for k, n in train_mamba2_1_3b()["launches_total"].items():
        launches[k] += n
    phase_done("6d train_mamba2_1_3b")

    # phase 6e: the reduced arctic trained on the card and on the CPU (its
    # launches are a check's, not the main path's)
    train_arctic_reduced()
    phase_done("6e train_arctic_reduced")

    for k, n in measure_launches.items():
        launches[k] += n

    # phases 5e, 5f and 6f: the MLA family at full size
    for k, n in serve_mla("deepseek-v2-lite-16b", MOE_MESH)[
            "launches"]["generate"].items():
        launches[k] += n
    phase_done("5e serve_deepseek_v2_lite_16b")
    for k, n in serve_mla("minicpm3-4b", None)[
            "launches"]["generate"].items():
        launches[k] += n
    phase_done("5f serve_minicpm3_4b")
    for k, n in train_minicpm3_4b()["launches_total"].items():
        launches[k] += n
    phase_done("6f train_minicpm3_4b")
    # phase 6h: the reduced MLA archs on the card against the CPU, their
    # attention on the padded (24, 16) pair (a check's launches)
    reduced_mla()
    phase_done("6h reduced_mla")

    # phase 7: kernel timings at the main paths' shapes, before phases
    # 5g-4i: the profiler traces nothing more in a process once it has
    # traced ~98,000 kernels of 6g's step on top of the earlier phases'
    # traces (every kernel-alone time read "not measured" after them,
    # PERF.md § 6); each kernel's launches are filled in below
    kernels = time_kernels(log, checks, launches) + \
        time_model_kernels(checks, launches) + [time_ssd(checks, launches)]
    phase_done("7 timings")

    # phases 5g and 6g: the hybrid zamba2-2.7b at full size; 4i: the
    # memory autopilot (its scenarios, its reshard search on the card and
    # a real-step run restored from its checkpoint); after every earlier
    # phase, as 5e-6f are
    for k, n in serve_zamba2_2_7b()["launches"]["generate"].items():
        launches[k] += n
    phase_done("5g serve_zamba2_2_7b")
    for k, n in train_zamba2_2_7b()["launches_total"].items():
        launches[k] += n
    phase_done("6g train_zamba2_2_7b")
    for k, n in autopilot_phase().items():
        launches[k] += n
    phase_done("4i autopilot")
    # phase 9: the training launcher — its report, its guard, smollm-360m
    # trained at published width through it, and the sharding helpers on a
    # 1 x 1 DeviceMesh; last, so that every earlier phase meets the caching
    # allocator as before it
    for k, n in launch_phase().items():
        launches[k] += n
    phase_done("9 launch_train_smollm_360m")
    # phase 10: the surface, each entry point in a process of its own on
    # the card (its launches are that process's, not this one's)
    surface_phase()
    phase_done("10 surface")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            fail(f"{k['name']}: the main path launched it no time")
        say_kernel(with_ratios(k))
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
