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
through ``repro_torch.serve.generate``, and llava15-7b training steps at the
paper's fig2b setting through ``repro_torch.train`` — and holds every
hand-written kernel against its plain PyTorch version on the card.
Phases (any failure exits non-zero):

1. toolchain + card line, then the kernels' build (set-up time) and the
   ``ptxas`` line: registers, spills and stack of the bf16 tensor-core
   flash and SSD kernels from ``ptxas -v``;
2. ``kernels_check``: ``shard_factor`` on randomized step programs, one
   request per launch and packed builds of up to 400 requests per launch
   (broadcast operands, dims past 2^31, the kernel's limits; bit-equal on
   a second launch; requests past the limits and malformed buffers
   refused), and ``segmented_cummax`` on random delta stacks, kernel ==
   plain version, exact int64 equality (tolerance 0); ``flash_fwd`` and
   ``rmsnorm_fwd`` on the reference's kernel-test cases and at the
   serving and the training paths' shapes, in fp32 (tolerance 2e-5; the
   plain version's matmuls in full fp32, ``allow_tf32`` off) and bf16 (tolerance 2e-2), on ``out`` and ``lse``;
   ``flash_bwd`` (the dq and the dk/dv kernels) on the same cases, the
   training path's shapes and the reduced configs' head dim 16, fp32
   within 5e-4 and bf16 within 2e-2 of each
   gradient's scale, and ``rmsnorm_bwd`` (dx and dscale, 1e-4 / 2e-2),
   each (the forward too) also bit-equal on a second launch, and every
   wrapper refusing what its kernel does not take (a bf16 view off the
   16-byte grid for the tensor-core kernels); ``ssd_scan`` (fp32: the FMA
   kernel; bf16: the tensor-core kernel) on the reference's three SSD
   cases, a prompt shorter than the chunk, the mamba2 prefill's full-width
   shape (4, 2,000, 64, 64, 128, 256) and its batch-1 twin, and a state
   width the bf16 kernel pads (N 20, P 128): y and the final state within
   1e-4 in fp32, bf16 y within 2e-2 and the state within 1e-4 of their
   scales, bit-equal on a second launch and on strided views, bf16
   operands off the copies' grid refused; every error also per shape;
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
7. timings: cold / warm wall time, cells/s and the phase split of each
   sweep, and per kernel — at the largest shape its path gave it — the
   median of CUDA-event-timed calls of its wrapper (``ms``), the kernel's
   own device time from a profiler trace (``device_ms``), the plain
   version's time, the roofline bound and the time of the one PyTorch
   call that computes the same function, where there is one (none for
   the SSD scan), with ``share_of_bound`` (bound / kernel alone) and
   ``vs_library`` (kernel alone / library call); the sweep kernels with
   the L2 flushed before each timed launch (their operands fit in it),
   ``shard_factor`` at the packed shape of the sweeps' largest table
   build.

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

import copy
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
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
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FL  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import segmented_cummax as SC  # noqa: E402
from repro_torch.kernels import shard_factor as SF  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import param as PM  # noqa: E402
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
# bf16 plain path's own (logits and states): the tensor-core SSD rounds its
# score operand and the state once more than the plain path; the CPU
# rounding model (tests/test_torch_ssd.py) reads 0.84 / 1.00 on the
# reduced config, 1.5 leaves room for 48 layers
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
    import ctypes
    lim = [ctypes.c_int() for _ in range(4)]
    _build.load().shard_factor_limits(*map(ctypes.byref, lim))
    if [v.value for v in lim] != [SF.MAX_DIMS, SF.MAX_AXES, SF.MAX_STEPS,
                                  SF.TILE]:
        fail(f"shard_factor kernel limits {[v.value for v in lim]} != the "
             f"wrapper's")
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
                 limit_request(SF.MAX_DIMS, SF.MAX_AXES, dup=1)):
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
    if refused != 6:
        fail(f"shard_factor_batch refused {refused} of 6 requests or "
             f"buffers the kernel does not take")
    return cases + refused, max_err


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
]
TRAIN_ROWS = (TRAIN_BATCH * 2048, 4096)        # the LM's RMSNorms, training
RMSNORM_SHAPES = [(64, 128), (3, 50, 96), (2, 7, 33, 64), (5, 33),
                  (4 * 1088, 4096), (4, 1, 4096), TRAIN_ROWS,
                  # mamba2 serving: the prefill's gated norm over d_inner
                  # and block norm, the block norm in a decode step
                  (4 * 2000, 4096), (4 * 2000, 2048), (4, 1, 2048)]
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def case_key(case) -> str:
    """The key of one checked shape in a check's ``max_abs_err_by_case``."""
    return "x".join(str(int(c)) for c in case)


def _note(errs: dict, by_case: dict, case, key: str, err: float) -> None:
    """Record one comparison's max |diff| overall and for its shape."""
    errs[key] = max(errs.get(key, 0.0), err)
    row = by_case.setdefault(case_key(case), {})
    row[key] = max(row.get(key, 0.0), err)


def _excess(got, want, tol) -> tuple:
    """(max |got - want|, max of |got - want| - tol * (1 + |want|)): the
    second is > 0 where allclose(atol=tol, rtol=tol) fails."""
    d = (got.float() - want.float()).abs()
    return (float(d.max()),
            float((d - tol * (1 + want.float().abs())).max()))


def _refuses(call, errors=(TypeError, ValueError)) -> bool:
    try:
        call()
    except errors:
        return True
    return False


def unaligned_bf16(shape) -> torch.Tensor:
    """A contiguous bf16 tensor that starts 2 bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=torch.bfloat16, device=DEV)[1:] \
        .view(shape)


def check_flash() -> dict:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    errs, by_case = {}, {}
    cases = 0
    for dt in (torch.float32, torch.bfloat16):
        for (b, sq, skv, h, hkv, d, dv, causal) in FLASH_CASES:
            q = torch.randn(b, sq, h, d, generator=gen, device=DEV).to(dt)
            k = torch.randn(b, skv, hkv, d, generator=gen, device=DEV).to(dt)
            v = torch.randn(b, skv, hkv, dv, generator=gen,
                            device=DEV).to(dt)
            qoff = skv - sq if causal else 0
            out, lse = FL.flash_fwd(q, k, v, causal=causal, q_offset=qoff)
            again = FL.flash_fwd(q, k, v, causal=causal, q_offset=qoff)
            torch.cuda.synchronize()
            if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
                fail(f"flash_fwd: two launches differ ({dt}, case "
                     f"{(b, sq, skv, h, hkv, d, dv, causal)})")
            p_out, p_lse = FL.flash_fwd_plain(q, k, v, causal=causal,
                                              q_offset=qoff)
            tol = TOLERANCE[dt]
            for what, got, want in (("out", out, p_out),
                                    ("lse", lse, p_lse)):
                err, over = _excess(got, want, tol)
                _note(errs, by_case, (b, sq, skv, h, hkv, d, dv, causal),
                      f"{what}_{str(dt).split('.')[-1]}", err)
                if over > 0 or got.shape != want.shape:
                    fail(f"flash_fwd kernel != plain version ({what}, "
                         f"{dt}, case {(b, sq, skv, h, hkv, d, dv, causal)}"
                         f": max abs diff {err}, tolerance {tol})")
            cases += 1
            del q, k, v, out, lse, again, p_out, p_lse
    # what the kernels do not take raises (no fallback)
    q = torch.zeros(1, 8, 4, 64, device=DEV)
    bad = [lambda: FL.flash_fwd(q[..., :48], q[..., :48], q[..., :48]),
           lambda: FL.flash_fwd(q.transpose(1, 2), q.transpose(1, 2),
                                q.transpose(1, 2)),
           lambda: FL.flash_fwd(q.half(), q.half(), q.half()),
           # contiguous bf16 at a 2-byte offset: off cp.async's 16 bytes
           lambda: FL.flash_fwd(*[unaligned_bf16(q.shape)] * 3)]
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
                                     (2, 70, 70, 2, 2, 16, 16, True)]
RMSNORM_BWD_SHAPES = RMSNORM_SHAPES[:4] + [TRAIN_ROWS, (40, 96)]
BWD_TOLERANCE = {"flash": {torch.float32: 5e-4, torch.bfloat16: 2e-2},
                 "rmsnorm": {torch.float32: 1e-4, torch.bfloat16: 2e-2}}


def _bwd_excess(got, want, dt, tol) -> tuple:
    """(max |got - want|, excess): fp32 as allclose(atol=rtol=tol), bf16
    against tol times the compared tensor's scale (its max magnitude)."""
    if dt == torch.float32:
        return _excess(got, want, tol)
    d = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    return float(d.max()), float(d.max()) - tol * scale


def check_flash_bwd() -> dict:
    """dq, dk and dv of the two kernels against flash_bwd_plain; a second
    launch bit-equal to the first; the autograd Function's gradients equal
    the wrapper's."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 3)
    errs, by_case = {}, {}
    cases = 0
    for dt in (torch.float32, torch.bfloat16):
        tol = BWD_TOLERANCE["flash"][dt]
        for case in FLASH_BWD_CASES:
            b, sq, skv, h, hkv, d, dv, causal = case
            q = torch.randn(b, sq, h, d, generator=gen, device=DEV).to(dt)
            k = torch.randn(b, skv, hkv, d, generator=gen, device=DEV).to(dt)
            v = torch.randn(b, skv, hkv, dv, generator=gen,
                            device=DEV).to(dt)
            do = torch.randn(b, sq, h, dv, generator=gen, device=DEV).to(dt)
            qoff = skv - sq if causal else 0
            out, lse = FL.flash_fwd(q, k, v, causal=causal, q_offset=qoff)
            got = FL.flash_bwd(q, k, v, out, lse, do, causal=causal,
                               q_offset=qoff)
            again = FL.flash_bwd(q, k, v, out, lse, do, causal=causal,
                                 q_offset=qoff)
            torch.cuda.synchronize()
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                fail(f"flash_bwd: two launches differ ({dt}, case {case})")
            want = FL.flash_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                      q_offset=qoff)
            for what, g, w in zip(("dq", "dk", "dv"), got, want):
                err, over = _bwd_excess(g, w, dt, tol)
                _note(errs, by_case, case, f"{what}_{str(dt).split('.')[-1]}",
                      err)
                if over > 0 or g.shape != w.shape or g.dtype != w.dtype:
                    fail(f"flash_bwd kernels != plain version ({what}, "
                         f"{dt}, case {case}: max abs diff {err}, "
                         f"tolerance {tol})")
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
    # what the kernels do not take raises (no fallback)
    z = torch.zeros(1, 8, 4, 64, device=DEV)
    lz = torch.zeros(1, 4, 8, device=DEV)
    bad = [lambda: FL.flash_bwd(z.half(), z.half(), z.half(), z.half(), lz,
                                z.half()),
           lambda: FL.flash_bwd(*(t[..., :48] for t in (z, z, z, z)), lz,
                                z[..., :48]),
           lambda: FL.flash_bwd(z, z, z, z, lz, torch.zeros(
               1, 4, 8, 64, device=DEV).transpose(1, 2)),
           lambda: FL.flash_bwd_dkv(z, z, z, lz, z, lz[:, :2]),
           # contiguous bf16 at a 2-byte offset: off cp.async's 16 bytes
           lambda: FL.flash_bwd_dq(*[unaligned_bf16(z.shape)] * 4, lz,
                                   unaligned_bf16(z.shape)),
           lambda: FL.flash_bwd_dkv(*[unaligned_bf16(z.shape)] * 3, lz,
                                    unaligned_bf16(z.shape), lz)]
    for call in bad:
        if not _refuses(call):
            fail("flash_bwd accepted an input the kernels do not take")
        cases += 1
    return {"name": "flash_bwd", "ok": True, "cases": cases,
            "max_abs_err": max(errs.values()), "max_abs_err_by": errs,
            "max_abs_err_by_case": by_case,
            "deterministic": True,
            "tolerance": {"float32": 5e-4, "bfloat16": "2e-2 of scale"}}


def check_rmsnorm_bwd() -> dict:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 4)
    errs, by_case = {}, {}
    cases = 0
    for dt in (torch.float32, torch.bfloat16):
        tol = BWD_TOLERANCE["rmsnorm"][dt]
        for shape in RMSNORM_BWD_SHAPES:
            x = torch.randn(shape, generator=gen, device=DEV).to(dt)
            sc = torch.randn(shape[-1:], generator=gen, device=DEV).to(dt)
            dy = torch.randn(shape, generator=gen, device=DEV).to(dt)
            # a row-offset view: off the 16-byte grid where D * elt is not
            # a multiple of 16 (the scalar path)
            for xs, dys in ((x, dy), (x.view(-1, shape[-1])[1:],
                                      dy.view(-1, shape[-1])[1:])):
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
                        fail(f"rmsnorm_bwd kernel != plain version ({what},"
                             f" {dt}, {tuple(xs.shape)}: max abs diff "
                             f"{err})")
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
# the reference's three cases, S < chunk, the serving shape, its batch-1
# twin (64 blocks: under half the card), and a state width that is not a
# multiple of 16 (the bf16 kernel pads it; 8-byte copies) at head dim 128
SSD_CASES = [(2, 128, 4, 16, 32, 32), (1, 96, 2, 32, 16, 32),
             (1, 64, 1, 64, 64, 64), (2, 40, 3, 16, 16, 64), SERVE_SSD_CASE,
             (1,) + SERVE_SSD_CASE[1:], (2, 75, 3, 128, 20, 32)]
SSD_TOLERANCE = 1e-4          # fp32 y and state; bf16 state, of its scale
SSD_BF16_Y_TOLERANCE = 2e-2   # bf16 y, of its scale (one rounding of y)


def ssd_inputs(case, gen, dtype):
    """x, dt (post-softplus), A (< 0), B, C on the card.  The reference's
    test distribution (dt ~ softplus(N(0, 1))) on its own cases; at the
    serving width (any batch) dt ~ softplus(N(0, 1) - 3), ~0.05, so the
    state carries across chunks as a served model's does."""
    b, S, H, P, N, _ = case
    shift = 3.0 if case[1:] == SERVE_SSD_CASE[1:] else 0.0
    x = torch.randn(b, S, H, P, generator=gen, device=DEV) * 0.5
    dt = F.softplus(torch.randn(b, S, H, generator=gen, device=DEV) - shift)
    A = -torch.exp(torch.randn(H, generator=gen, device=DEV) * 0.3)
    Bm = torch.randn(b, S, N, generator=gen, device=DEV) * 0.5
    Cm = torch.randn(b, S, N, generator=gen, device=DEV) * 0.5
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


def check_ssd() -> dict:
    """y and the final state of the kernels (fp32: FMA, bf16: tensor
    cores) against ssd_scan_plain on every case; a second launch bit-equal;
    x, B and C read in place through a token stride (views into one
    conv-output buffer, as the model hands them) bit-equal to contiguous
    copies; what the kernels do not take refused."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 5)
    errs, by_case = {}, {}
    cases = 0
    for dt_ in (torch.float32, torch.bfloat16):
        tag = str(dt_).split(".")[-1]
        for case in SSD_CASES:
            chunk = case[-1]
            args = ssd_inputs(case, gen, dt_)
            y, st = SSD.ssd_scan(*args, chunk=chunk)
            y2, st2 = SSD.ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(st, st2)):
                fail(f"ssd_scan: two launches differ ({dt_}, case {case})")
            py, pst = SSD.ssd_scan_plain(*args, chunk=chunk)
            for what, got, want in (("y", y, py), ("state", st, pst)):
                if dt_ == torch.float32:
                    err, over = _excess(got, want, SSD_TOLERANCE)
                else:
                    tol = SSD_BF16_Y_TOLERANCE if what == "y" \
                        else SSD_TOLERANCE
                    err, over = _bwd_excess(got, want, dt_, tol)
                _note(errs, by_case, case, f"{what}_{tag}", err)
                if over > 0 or got.shape != want.shape or \
                        got.dtype != want.dtype or \
                        not bool(torch.isfinite(got).all()):
                    fail(f"ssd_scan kernel != plain version ({what}, {dt_},"
                         f" case {case}: max abs diff {err})")
            if case == SERVE_SSD_CASE:
                x, dtv, A, Bm, Cm = args
                b, S, H, P, N, _ = case
                buf = torch.cat([x.reshape(b, S, H * P), Bm, Cm], dim=-1)
                xv = buf[..., :H * P].view(b, S, H, P)
                Bv, Cv = buf[..., H * P:H * P + N], buf[..., H * P + N:]
                yv, stv = SSD.ssd_scan(xv, dtv, A, Bv, Cv, chunk=chunk)
                torch.cuda.synchronize()
                if not (torch.equal(yv, y) and torch.equal(stv, st)):
                    fail(f"ssd_scan on strided views != on contiguous "
                         f"copies ({dt_})")
                del buf, xv, Bv, Cv, yv, stv
            cases += 1
            del args, y, st, y2, st2, py, pst
    # what the kernel does not take raises (no fallback)
    x, dtv, A, Bm, Cm = ssd_inputs((1, 8, 2, 64, 16, 8), gen, torch.float32)
    for call in (lambda: SSD.ssd_scan(x[..., :48], dtv, A, Bm, Cm),
                 lambda: SSD.ssd_scan(x, dtv, A, Bm[..., :14], Cm[..., :14]),
                 lambda: SSD.ssd_scan(x.transpose(2, 3).contiguous()
                                      .transpose(2, 3), dtv, A, Bm, Cm),
                 lambda: SSD.ssd_scan(x.half(), dtv, A, Bm.half(),
                                      Cm.half()),
                 lambda: SSD.ssd_scan(*ssd_inputs((1, 30000, 2, 64, 128, 1),
                                                  gen, torch.float32),
                                      chunk=30000),
                 # bf16 x off the 16-byte grid, B off the 8-byte grid
                 lambda: SSD.ssd_scan(unaligned_bf16(x.shape), dtv, A,
                                      Bm.bfloat16(), Cm.bfloat16()),
                 lambda: SSD.ssd_scan(x.bfloat16(), dtv, A,
                                      unaligned_bf16(Bm.shape),
                                      Cm.bfloat16())):
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
        self.sc = None          # deltas (host)
        self._sf, self._sc = SF.shard_factor_batch, SC.segmented_cummax

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


# the bf16 tensor-core kernels: name in the kernels line -> (CUDA kernel,
# FL.mma_smem_bytes kind)
MMA_KERNELS = {"flash_fwd": ("flash_fwd_kernel_mma", "fwd"),
               "flash_dq": ("flash_bwd_dq_kernel_mma", "dq"),
               "flash_dkv": ("flash_bwd_dkv_kernel_mma", "dkv")}
MMA_TILES = {"fwd": FL.FWD_TILE, "dq": FL.DQ_TILE, "dkv": FL.DKV_TILE}
SSD_MMA_KERNEL = "ssd_scan_kernel_mma"


def mma_resources() -> dict:
    """``ptxas -v``'s registers, spills and stack of every instance of the
    tensor-core kernels, by ``kernel<D,Dv>`` (flash) / ``kernel<P>``
    (SSD)."""
    out = {}
    kernels = [kern for kern, _ in MMA_KERNELS.values()] + [SSD_MMA_KERNEL]
    for name, r in _build.kernel_resources().items():
        for kern in kernels:
            if kern in name:
                dims = re.findall(r"Li(\d+)E", name)
                out[f"{kern}<{','.join(dims)}>"] = r
    return out


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


def logits_agree(got, want, what: str, problems: list = None) -> dict:
    """The serving tests' tolerance: |got - want| <= 2e-2 * max(1,
    max|want|), and the same greedy token wherever want's top-2 margin
    exceeds twice that.  A miss fails the run at once, or with
    ``problems`` is added to it (the caller fails after its line)."""
    got, want = got.float(), want.float()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * 2e-2 * scale
    same = got.argmax(-1) == want.argmax(-1)
    miss = None
    if not bool(torch.isfinite(got).all()):
        miss = f"{what}: non-finite logits"
    elif err > 2e-2 * scale or not bool(same[clear].all()):
        miss = (f"{what}: max abs diff {err} against tolerance "
                f"{2e-2 * scale}, greedy tokens equal where clear: "
                f"{bool(same[clear].all())}")
    if miss and problems is None:
        fail(miss)
    if miss:
        problems.append(miss)
    return {"max_abs_err": err, "scale": scale,
            "clear_tokens": int(clear.sum()),
            "same_tokens": int(same.sum()), "tokens": int(same.numel())}


def reduced_card_vs_cpu(arch: str, make_batch, counts) -> dict:
    """The reduced ``arch``, same weights and batch (``make_batch(cfg,
    generator)`` on the CPU), on the card (kernels) and on the CPU (plain
    versions): prefill + 4 decode steps; ``counts()`` the kernels the card
    run must launch."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    cpu_params = model.init(gen, "cpu")
    cpu_batch = make_batch(cfg, gen)
    card_params = copy.deepcopy(cpu_params).to(DEV)
    card_batch = {k: v.to(DEV) for k, v in cpu_batch.items()}
    prefill, decode = SV.make_prefill_step(model), SV.make_decode_step(model)
    before = counts()
    out = {}
    lc, cc = prefill(cpu_params, cpu_batch)
    lg, cg = prefill(card_params, card_batch)
    out["prefill"] = logits_agree(lg.cpu(), lc,
                                  f"reduced {arch} prefill card/cpu")
    cc, cg = SV.pad_cache(cc, 4), SV.pad_cache(cg, 4)
    tok = lc[:, -1].argmax(-1)[:, None].to(torch.int32)
    for i in range(4):
        tok_next, lc, cc = decode(cpu_params, tok, cc)
        _, lg, cg = decode(card_params, tok.to(DEV), cg)
        out[f"decode_{i}"] = logits_agree(lg.cpu(), lc,
                                          f"reduced {arch} decode {i} "
                                          f"card/cpu")
        tok = tok_next
    used = {k: counts()[k] - before[k] for k in before}
    if min(used.values()) <= 0:
        fail(f"reduced {arch} card run launched no kernel: {used}")
    out["launches"] = used
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
    # FMA kernel, "flash_fwd_kernel_mma" the bf16 tensor-core one
    part = {name.rstrip("<"): sum(r[0] for r in rows if name in r[1])
            for name in ("flash_fwd_kernel_mma", "flash_fwd_kernel<",
                         "flash_bwd_dq_kernel_mma", "flash_bwd_dq_kernel<",
                         "flash_bwd_dkv_kernel_mma", "flash_bwd_dkv_kernel<",
                         "rmsnorm_fwd_kernel", "rmsnorm_bwd_kernel",
                         "ssd_scan_kernel_mma", "ssd_scan_kernel<")}
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
    over the compared tensor's scale."""
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
    out["logits_scale"] = float(runs["bf16_plain"][0].abs().max())
    return out


def check_mamba_paths(paths: dict, problems: list) -> None:
    """The gates on ``mamba_prefill_paths``: in fp32 the kernel path
    equals the plain path within MAMBA_FP32_TOL of the logits' and the
    states' scale, with the same greedy tokens where the margin is clear.
    In bf16 the two paths differ by the rounding spread of 48 random layers
    (PERF.md § 6), so the bf16 kernel path is held to no more than
    MAMBA_BF16_RATIO times the bf16 plain path's distance from the fp32
    plain path, on logits and states; a miss goes to ``problems`` (the
    caller fails after its line prints)."""
    f = paths["fp32_kernels_vs_fp32_plain"]
    if max(f.values()) > MAMBA_FP32_TOL:
        fail(f"mamba2 fp32 prefill, kernel path vs plain path: {f} of "
             f"scale (tolerance {MAMBA_FP32_TOL})")
    t = paths["fp32_tokens"]
    if t["same_where_clear"] != t["clear"]:
        fail(f"mamba2 fp32 prefill: greedy tokens differ where clear: {t}")
    got = paths["bf16_kernels_vs_fp32_plain"]
    plain = paths["bf16_plain_vs_fp32_plain"]
    for key in got:
        if got[key] > MAMBA_BF16_RATIO * plain[key]:
            problems.append(
                f"mamba2 bf16 prefill {key}: the kernel path is {got[key]} "
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
        check_mamba_paths(paths, problems)
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
    vision tower: the ViT's 24 attention forwards; each LM block's
    attention forward and its two RMSNorms twice (the recompute reruns the
    block in the backward), its attention backward and RMSNorm backwards
    once; the final norm once each way."""
    n = cfg.n_layers
    return {"flash_fwd": cfg.vlm.vit_layers + 2 * n, "flash_dq": n,
            "flash_dkv": n, "rmsnorm_fwd": 2 * 2 * n + 1,
            "rmsnorm_bwd": 2 * n + 1}


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
    """Per tensor max |got - want| / max |want|; every tensor must stay
    within ``tol`` of its scale (``tol`` None: a reading, no gate)."""
    worst, worst_leaf, worst_norm = 0.0, None, 0.0
    for name, w in want.items():
        w = w.float()
        d = got[name].float().to(w.device) - w
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


def reduced_train_card_vs_cpu(problems: list) -> dict:
    """The reduced llava15-7b, same weights and batch, one LLaVA stage-2
    step on the card (kernels) and on the CPU (plain versions): loss,
    gradients and updated params within 2e-2 of each tensor's scale."""
    cfg = get_config(TRAIN_ARCH).reduced()
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    params = {"cpu": model.init(gen, "cpu")}
    batches = {"cpu": train_batch(cfg, gen, 2, 8)}
    params["card"] = copy.deepcopy(params["cpu"]).to(DEV)
    batches["card"] = {k: v.to(DEV) for k, v in batches["cpu"].items()}
    opt_cfg = OptimizerConfig(name="adamw")
    step = make_train_step(model, LLAVA_STAGE2, opt_cfg, remat="block")
    before = model_counts()
    res = {}
    for side in ("cpu", "card"):
        st = train_state(params[side], LLAVA_STAGE2, opt_cfg)
        loss, grads = loss_and_grads(model, st.params, batches[side])
        st, metrics = step(st, batches[side])
        res[side] = (loss, grads, dict(st.params.named_parameters()),
                     float(metrics["loss"]))
    used = {k: model_counts()[k] - before[k] for k in before}
    if min(used.values()) <= 0:
        problems.append(f"reduced card training launched a kernel no time: "
                        f"{used}")
    (l_cpu, g_cpu, p_cpu, m_cpu) = res["cpu"]
    (l_card, g_card, p_card, m_card) = res["card"]
    for a, b, what in ((l_card, l_cpu, "loss"), (m_card, m_cpu, "step loss")):
        if abs(a - b) > 2e-2 * max(1.0, abs(b)):
            problems.append(f"reduced train card/cpu: {what} {a} vs {b}")
    return {"loss": {"card": l_card, "cpu": l_cpu},
            "grads": grads_agree(g_card, g_cpu, 2e-2,
                                 "reduced train card/cpu grads", problems),
            "params": grads_agree({k: v.detach() for k, v in p_card.items()},
                                  {k: v.detach() for k, v in p_cpu.items()},
                                  2e-2, "reduced train card/cpu params",
                                  problems),
            "launches": used}


def train_phase(name: str, cfg, policy, cut: str, problems: list) -> dict:
    """TRAIN_STEPS steps of ``policy`` at the fig2b batch through
    ``init_train_state`` / ``make_train_step`` (the entry points a user
    calls), each step's time, launches and allocator peak; the gates; one
    step under the profiler; the kernel path against the plain path; the
    byte model's prediction for the same config."""
    model = build_model(cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    opt_cfg = OptimizerConfig(name="adamw")
    torch.cuda.synchronize()
    at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = init_train_state(model, policy, opt_cfg, gen, DEV)
    batch = train_batch(cfg, gen, TRAIN_BATCH, TRAIN_TEXT)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    before = checksums(state.params)
    # each trainable tensor's slice of its leaf's (stacked) fp32 master
    masters = {n: state.opt[leaf.name]["master"][i] if leaf.stacked
               else state.opt[leaf.name]["master"]
               for leaf in PM.trainable_leaves(state.params)
               for i, (n, _) in enumerate(leaf.params)}
    masters_before = checksums_of(masters)
    trainable = set(masters)
    step = make_train_step(model, policy, opt_cfg, remat="block")
    want = train_program(cfg)

    steps = []
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
    # a trainable leaf moves in its fp32 master copy (the optimizer's
    # parameter); its bf16 copy may round back to the same value, as a
    # norm scale of 1.0 does under steps of ~lr; a frozen leaf is
    # bit-equal in the model
    after = checksums(state.params)
    masters_after = checksums_of(masters)
    still = sorted(n for n in trainable
                   if masters_after[n] == masters_before[n])
    moved = sorted(n for n in before if n not in trainable
                   and after[n] != before[n])
    if still or moved or not trainable:
        problems.append(f"{name}: trainable leaves that did not move "
                        f"{still[:4]}, frozen leaves that moved {moved[:4]}")
    bf16_moved = sum(after[n] != before[n] for n in trainable)

    # where the device time goes: one more step under the profiler
    med_ms = statistics.median(s["ms"] for s in steps)
    on_device = device_breakdown(lambda: step(state, batch), med_ms, top=8)

    # the kernel path against the plain path, same weights and batch
    vs_plain = {}
    zero_counts()
    k_loss, k_grads = loss_and_grads(model, state.params, batch)
    if model_counts() != want:
        problems.append(f"{name}: loss and grads launched {model_counts()}")
    zero_counts()
    with PlainKernels():
        p_loss, p_grads = loss_and_grads(model, state.params, batch)
    if any(model_counts().values()):
        problems.append(f"{name}: the plain path launched a kernel")
    bf16 = {"loss": {"kernels": k_loss, "plain": p_loss},
            "grads": grads_agree(k_grads, p_grads, None, "", [])}
    # the gate: the same in fp32 (the fp32 kernels; bf16 rounding out of
    # the way), on the same weights cast to fp32, every trainable leaf
    # within FP32_GRAD_TOL of its scale
    del state.opt, masters
    gc.collect()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = state.params.float()
    f_loss, f_grads = loss_and_grads(model32, params32, batch)
    with PlainKernels():
        fp_loss, fp_grads = loss_and_grads(model32, params32, batch)
    vs_plain["fp32"] = {
        "loss": {"kernels": f_loss, "plain": fp_loss},
        "grads": grads_agree(f_grads, fp_grads, FP32_GRAD_TOL,
                             f"{name} fp32 kernel path vs plain path",
                             problems)}
    del fp_grads
    for what, a, b in (("bf16", k_loss, p_loss), ("fp32", f_loss, fp_loss)):
        if abs(a - b) > 2e-2 * max(1.0, abs(b)):
            problems.append(f"{name}: {what} loss {a} through the kernels, "
                            f"{b} through the plain versions")
    # a reading: each bf16 path's gradients against the fp32 kernel path's
    bf16["vs_fp32"] = {path: grads_agree(grads, f_grads, None, "", [])
                       for path, grads in (("kernels", k_grads),
                                           ("plain", p_grads))}
    vs_plain["bf16"] = bf16
    del f_grads, k_grads, p_grads, params32

    pred = PR.predict(model, policy, FA.PredictContext(
        kind="train", global_batch=TRAIN_BATCH,
        seq_len=TRAIN_TEXT + cfg.vlm.n_image_tokens, remat="block",
        optimizer="adamw", backend="tpu"))
    peak = max(s["peak_bytes"] for s in steps)
    out = {"arch": cfg.name, "cut": cut, "policy": policy.name,
           "n_layers": cfg.n_layers, "batch": TRAIN_BATCH,
           "tokens_per_sample": TRAIN_TEXT + cfg.vlm.n_image_tokens,
           "image_tokens": cfg.vlm.n_image_tokens, "text_tokens": TRAIN_TEXT,
           "params": sum(t.numel() for t in state.params.parameters()),
           "trainable_params": sum(t.numel() for _, t in
                                   PM.trainable_params(state.params)),
           "optimizer": "adamw", "remat": "block", "init_s": init_s,
           "ms_per_step": [s["ms"] for s in steps],
           "loss_per_step": [s["loss"] for s in steps],
           "launches_per_step": steps[-1]["launches"],
           "launches_total": {k: sum(s["launches"][k] for s in steps)
                              for k in want},
           "tokens_per_s": TRAIN_BATCH * (TRAIN_TEXT
                                          + cfg.vlm.n_image_tokens)
           / (med_ms / 1e3),
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
           "vs_plain": vs_plain, "on_device": on_device}
    del state, batch, model, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


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


def device_ms(fn, kernel_name: str, launches: int = 20,
              flush: bool = False):
    """Mean device time of the named CUDA kernel over ``launches`` calls of
    ``fn``, from a torch.profiler trace — the kernel alone, without the
    wrapper's host work that the event timing includes; with ``flush`` an
    L2 flush (a kernel of its own) before each call.  None when the
    profiler reports no device time for it (then only the event time is
    known, and the report says "not measured")."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
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
        return None
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            total_us = getattr(ev, "device_time_total", None)
            if total_us is None:
                total_us = getattr(ev, "cuda_time_total", 0)
            if total_us and ev.count:
                return total_us / ev.count / 1e3
    return None


def shard_factor_work(p: "SF.Packed") -> tuple:
    """Bytes and operations of one batched launch on ``p``: every packed
    buffer read once (the compact operands, descriptors, request table,
    programs and tiles) and 8 bytes written per cell; 4 int64 operations
    (multiply, remainder, compare, select) per step and cell."""
    n_bytes = 8 * (p.operands.size + p.rows.size + p.requests.size
                   + p.steps.size + p.tiles.size + p.n_out)
    n_ops = 4 * int((p.requests[:, SF.REQ_STEPS]
                     * p.requests[:, SF.REQ_N]).sum())
    return n_bytes, n_ops


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
    sf_bytes, sf_ops = shard_factor_work(packed)
    sf_bound = max(sf_bytes / HBM_BYTES_PER_S, sf_ops / ALU_OPS_PER_S)
    sf = {
        "name": "shard_factor", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/shard_factor.cu",
        "replaces": "src/repro/kernels/shard_factor.py:131",
        "launches": launches["shard_factor"],
        "max_abs_err": checks["shard_factor"]["max_abs_err"],
        "ms": event_ms(lambda: SF.shard_factor_batch(dev), flush=True),
        "plain_ms": event_ms(lambda: SF.shard_factor_batch_plain(dev),
                             flush=True),
        "bound_ms": sf_bound * 1e3,
        "bound_by": "bytes" if sf_bytes / HBM_BYTES_PER_S
        >= sf_ops / ALU_OPS_PER_S else "operations",
        "library_ms": None,
        "device_ms": device_ms(lambda: SF.shard_factor_batch(dev),
                               "shard_factor_batch_kernel", flush=True),
        "shape": {"requests": len(packed.requests), "cells": packed.n_out,
                  "operands": packed.operands.size,
                  "steps": len(packed.steps), "tiles": len(packed.tiles)},
        "bytes": sf_bytes, "operations": sf_ops,
        "l2": "flushed before each timed launch",
    }
    # the path the table build really takes: the packed host buffers up
    # in one copy from pinned memory, one launch, one read-back (host
    # clock, synchronised)
    sf["host_roundtrip_ms"] = host_ms(
        lambda: SF.shard_factor_batch(packed.to(DEV)).cpu())

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


def _flash_timing(shape: tuple, causal: bool, gen) -> dict:
    b, sq, h, d = shape
    q, k, v = (torch.randn(b, sq, h, d, generator=gen, device=DEV)
               .to(torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    n_ops = 4 * b * h * sq * sq * d * (0.5 if causal else 1.0)
    n_bytes = 4 * q.numel() * q.element_size() + 4 * b * h * sq
    bound_ms, bound_by = _bound(n_bytes, n_ops, BF16_OPS_PER_S)
    return {
        "shape": {"B": b, "S": sq, "H": h, "D": d, "causal": causal,
                  "dtype": "bfloat16"},
        "ms": event_ms(lambda: FL.flash_fwd(q, k, v, causal=causal)),
        "device_ms": device_ms(lambda: FL.flash_fwd(q, k, v, causal=causal),
                               "flash_fwd_kernel_mma"),
        "plain_ms": event_ms(
            lambda: FL.flash_fwd_plain(q, k, v, causal=causal), launches=10),
        "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)),
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
        "ms": event_ms(lambda: RN.rmsnorm_fwd(x, sc)),
        "device_ms": device_ms(lambda: RN.rmsnorm_fwd(x, sc),
                               "rmsnorm_fwd_kernel"),
        "plain_ms": event_ms(lambda: RN.rmsnorm_fwd_plain(x, sc)),
        "library_ms": event_ms(lambda: F.rms_norm(x, shape[-1:], sc, 1e-5)),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes}


def _flash_bwd_timing(shape: tuple, causal: bool, gen) -> tuple:
    """The dq and the dk / dv pass at one shape, each with its own bound;
    the plain version and the library call compute all three gradients,
    so those two times stand in both rows."""
    b, sq, h, d = shape
    q, k, v, do = (torch.randn(b, sq, h, d, generator=gen, device=DEV)
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = FL.flash_fwd(q, k, v, causal=causal)
    _, delta = FL.flash_bwd_dq(q, k, v, out, lse, do, causal=causal)
    plain_ms = event_ms(lambda: FL.flash_bwd_plain(q, k, v, out, lse, do,
                                                   causal=causal),
                        launches=10)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    library_ms = event_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), dot, retain_graph=True))
    scores = b * h * sq * sq * (0.5 if causal else 1.0)
    tensor = q.numel() * q.element_size()
    stat = 4 * b * h * sq
    rows = []
    for name, n_mm, n_bytes, fn, kern in (
            # dq pass: s, dp and dq; reads q k v out dout lse, writes dq
            # and delta
            ("flash_dq", 3, 6 * tensor + 2 * stat,
             lambda: FL.flash_bwd_dq(q, k, v, out, lse, do, causal=causal),
             "flash_bwd_dq_kernel_mma"),
            # dk / dv pass: s, dp, dv and dk; reads q k v dout lse delta,
            # writes dk dv
            ("flash_dkv", 4, 6 * tensor + 2 * stat,
             lambda: FL.flash_bwd_dkv(q, k, v, lse, do, delta,
                                      causal=causal),
             "flash_bwd_dkv_kernel_mma")):
        n_ops = 2 * n_mm * scores * d
        bound_ms, bound_by = _bound(n_bytes, n_ops, BF16_OPS_PER_S)
        rows.append({
            "shape": {"B": b, "S": sq, "H": h, "D": d, "causal": causal,
                      "dtype": "bfloat16"},
            "ms": event_ms(fn), "device_ms": device_ms(fn, kern),
            "plain_ms": plain_ms, "plain_covers": "dq, dk and dv",
            "library_ms": library_ms,
            "library_covers": "dq, dk and dv (SDPA backward)",
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": n_ops,
            "bytes": n_bytes})
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
        "ms": event_ms(lambda: RN.rmsnorm_bwd(x, sc, dy)),
        "device_ms": device_ms(lambda: RN.rmsnorm_bwd(x, sc, dy),
                               "rmsnorm_bwd_kernel"),
        "plain_ms": event_ms(lambda: RN.rmsnorm_bwd_plain(x, sc, dy)),
        "library_ms": event_ms(lambda: torch.autograd.grad(
            y, (xr, sr), dy, retain_graph=True)),
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
    dq, dkv = _flash_bwd_timing(lm_shape, True, gen)
    rn_main = _rmsnorm_timing((TRAIN_BATCH * S_train, cfg.d_model), gen)
    rn_other = [_rmsnorm_timing((SERVE_BATCH * S_serve, cfg.d_model), gen),
                _rmsnorm_timing((SERVE_BATCH, 1, cfg.d_model), gen),
                _rmsnorm_timing((MAMBA_BATCH * MAMBA_PROMPT, 4096), gen)]
    rn_bwd = _rmsnorm_bwd_timing((TRAIN_BATCH * S_train, cfg.d_model), gen)
    out = []
    # per kernel: its check, the outputs of that check that are its own,
    # and the checked shape it is timed at
    for name, src, repl, check, mine, case, main, others in (
            ("flash_fwd", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:45", "flash_fwd",
             ("out", "lse"), TRAIN_LM_CASE, fwd_main, fwd_other),
            ("flash_dq", "flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:165", "flash_bwd",
             ("dq",), TRAIN_LM_CASE, dq, []),
            ("flash_dkv", "flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:212", "flash_bwd",
             ("dk", "dv"), TRAIN_LM_CASE, dkv, []),
            ("rmsnorm_fwd", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:20",
             "rmsnorm_fwd", ("float32", "bfloat16"), TRAIN_ROWS, rn_main,
             rn_other),
            ("rmsnorm_bwd", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:28",
             "rmsnorm_bwd", ("dx", "dscale"), TRAIN_ROWS, rn_bwd, [])):
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
            kern, which = MMA_KERNELS[name]
            entry["tensor_cores"] = {
                "kernel": kern, "tile": list(MMA_TILES[which]),
                "threads": 256,
                "ptxas": mma_resources().get(f"{kern}<{d},{d}>"),
                "smem_bytes_per_block": FL.mma_smem_bytes(which, d, d)}
        entry["other_shapes"] = others
        for k in [entry] + others:
            if not (k["ms"] > 0 and k["plain_ms"] > 0 and k["bound_ms"] > 0
                    and k["library_ms"] > 0):
                fail(f"{name}: a timing came back non-positive")
        out.append(entry)
    return out


def with_ratios(k: dict) -> dict:
    """``share_of_bound`` = bound / the kernel alone on the device and
    ``vs_library`` = the kernel alone / the library call (None where a
    time is missing), on the entry and its other shapes."""
    for e in [k] + k.get("other_shapes", []):
        dev, lib = e["device_ms"], e.get("library_ms")
        e["share_of_bound"] = e["bound_ms"] / dev if dev else None
        e["vs_library"] = dev / lib if dev and lib else None
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


def time_ssd(checks: dict, launches: dict) -> dict:
    """The SSD kernel at the serving path's prefill shape, bf16 (the
    tensor-core kernel): the wrapper call (CUDA events, median of 30), the
    kernel alone (profiler, by its own name), the plain version; no single
    PyTorch call computes the SSD scan."""
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
    entry = {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:25",
        "launches": launches["ssd_scan"],
        "max_abs_err": c["max_abs_err"],
        "max_abs_err_at_shape": c["max_abs_err_by_case"][case_key(case)],
        "shape": {"b": b, "S": S, "H": H, "P": P, "N": N, "chunk": chunk,
                  "dtype": "bfloat16"},
        "ms": event_ms(lambda: SSD.ssd_scan(*args, chunk=chunk)),
        "device_ms": device_ms(lambda: SSD.ssd_scan(*args, chunk=chunk),
                               SSD_MMA_KERNEL),
        "plain_ms": event_ms(lambda: SSD.ssd_scan_plain(*args, chunk=chunk),
                             launches=10),
        "library_ms": None, "library": "none exists",
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": n_ops,
        "bytes": n_bytes,
        "grid_blocks": b * H, "sms": torch.cuda.get_device_properties(
            DEV).multi_processor_count,
        "smem_bytes_per_block": SSD.mma_smem_bytes(P, N, chunk),
        "tensor_cores": {"kernel": SSD_MMA_KERNEL,
                         "threads": 32 * SSD.MMA_WARPS,
                         "ptxas": mma_resources().get(
                             f"{SSD_MMA_KERNEL}<{P}>")}}
    if not (entry["ms"] > 0 and entry["plain_ms"] > 0
            and entry["bound_ms"] > 0):
        fail("ssd_scan: a timing came back non-positive")
    return entry


def say_kernel(k: dict) -> None:
    dev = "not measured" if k["device_ms"] is None \
        else f"{k['device_ms'] * 1e3:.1f} us"
    share = "" if k["share_of_bound"] is None \
        else f", {100 * k['share_of_bound']:.1f} % of the bound"
    lib = "" if k["vs_library"] is None \
        else f", {k['vs_library']:.2f}x the library call"
    say(f"kernel {k['name']}: {k['ms'] * 1e3:.1f} us/call by CUDA "
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
    args = ap.parse_args(argv)
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
        f"{_build.build_seconds:.1f} s (set-up) -> {_build.build_dir()}")
    resources = mma_resources()
    say("ptxas " + json.dumps(resources))
    spills = [k for k, r in resources.items()
              if r.get("spill_store_bytes") or r.get("spill_load_bytes")]
    if spills or not resources:
        print(f"chip_smoke: the tensor-core kernels spill registers or "
              f"ptxas reported nothing: {spills}", file=sys.stderr)

    # phase 2: kernels against their plain versions
    checks = {}
    for check in (check_shard_factor, check_segmented_cummax, check_flash,
                  check_rmsnorm, check_flash_bwd, check_rmsnorm_bwd,
                  check_ssd):
        c = check()
        checks[c["name"]] = c
    say("kernels_check " + json.dumps(list(checks.values())))
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
    serve = serve_llava15_7b()
    launches.update({k: 0 for k in model_counts()})
    launches.update(serve["launches"]["generate"])

    # phase 5b: serving mamba2-1.3b
    mamba = serve_mamba2_1_3b()
    launches["rmsnorm_fwd"] += mamba["launches"]["generate"]["rmsnorm_fwd"]
    launches["ssd_scan"] = mamba["launches"]["generate"]["ssd_scan"]

    # phase 6: training, stage 1 at full size, stage 2 with 8 LM blocks,
    # then stage 2's Adafactor and 8-bit Adam steps
    for phase in train_llava15_7b():
        for k, n in phase["launches_total"].items():
            launches[k] += n
    train_optimizers()

    # phase 7: kernel timings at the main paths' shapes
    kernels = time_kernels(log, checks, launches) + \
        time_model_kernels(checks, launches) + [time_ssd(checks, launches)]
    for k in kernels:
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
