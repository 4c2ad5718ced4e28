#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # needs one CUDA device and nvcc

Drives the port's main path — the capacity sweep of llava15-7b at its
published widths through ``SweepEngine.sweep(grid, engine="torch")`` on the
CUDA device — and holds every hand-written kernel against its plain PyTorch
version on the card.  Phases (any failure exits non-zero):

1. toolchain + card line, then the kernels' build (set-up time);
2. ``kernels``: ``shard_factor`` on randomized step programs and
   ``segmented_cummax`` on random delta stacks, kernel == plain version,
   exact int64 equality (tolerance 0);
3. ``sweep_large``: the 124,416-cell llava15-7b grid, legacy and liveness
   assembly, device engine == host columnar path column for column;
4. ``sweep_pipe``: the same grid with a ``pipe`` mesh axis, both schedules
   and three microbatch counts (1,959,552 cells), liveness assembly;
5. timings: cold / warm wall time, cells/s and the phase split of each
   sweep, and per kernel — at the largest shape the sweeps gave it — the
   median of CUDA-event-timed calls of its wrapper (``ms``), the kernel's
   own device time from a profiler trace (``device_ms``), the plain
   version's time and the roofline bound.

Each sweep is run with the kernels' launch counters set to 0 just before
and read just after; a kernel of the path that was launched no time fails
the run.  The line before the last is the ``nvidia-smi`` name / power-limit
line, the ``{"kernels": [...]}`` line stands before it, and the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
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

from repro_torch.core import batch as B  # noqa: E402
from repro_torch.core import planner as PL  # noqa: E402
from repro_torch.core import sweep as SW  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import segmented_cummax as SC  # noqa: E402
from repro_torch.kernels import shard_factor as SF  # noqa: E402

DEV = torch.device("cuda", 0)
SEED = 20260811

# H100 SXM data-sheet peaks the bounds are stated against
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12      # fp32 rate outside the tensor cores; the int64
                           # ALU work of both kernels is slower than that,
                           # so the operations bound errs low (still a bound)

RESULT_COLUMNS = ("peak_bytes", "budget_bytes", "fits", "offload_bytes",
                  "overlap_slack_bytes", "pool_bytes", "draft_bytes",
                  "hit_saved_bytes", "arch_c", "chip_c", "mesh_c", "opt_c",
                  "remat_c", "sched_c", "microbatches", "grad_accum",
                  "global_batch", "seq_len")


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
    strided = torch.ones((8, 2), dtype=torch.int64, device=DEV).t()
    too_many = torch.ones((SF.MAX_DIMS + 1, 8), dtype=torch.int64,
                          device=DEV)
    for bad in (d.to(torch.int32), strided, too_many):
        try:
            SF.shard_factor_tensors(bad, d, [(0, 0, 0)])
        except (TypeError, ValueError):
            cases += 1
        else:
            fail("shard_factor accepted an operand the kernel does not take")
    return {"name": "shard_factor", "ok": True, "cases": cases,
            "max_abs_err": max_err}


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


# ---------------------------------------------------------------------------
# phases 3-4: the sweeps
# ---------------------------------------------------------------------------


class ShapeLog:
    """Remembers, per kernel, the largest operands a sweep handed to its
    wrapper (so phase 5 times the kernels at the main path's shapes)."""

    def __init__(self):
        self.sf = None          # (dims, sizes, steps)
        self.sc = None          # deltas
        self._sf, self._sc = SF.shard_factor_tensors, SC.segmented_cummax

    def __enter__(self):
        def sf(dims, sizes, steps):
            if self.sf is None or dims.shape[1] * (
                    dims.shape[0] + sizes.shape[0]) > self.sf[0].shape[1] * (
                    self.sf[0].shape[0] + self.sf[1].shape[0]):
                self.sf = (dims.clone(), sizes.clone(), tuple(steps))
            return self._sf(dims, sizes, steps)

        def sc(deltas):
            if self.sc is None or deltas.numel() > self.sc.numel():
                self.sc = deltas.clone()
            return self._sc(deltas)
        SF.shard_factor_tensors, SC.segmented_cummax = sf, sc
        return self

    def __exit__(self, *exc):
        SF.shard_factor_tensors, SC.segmented_cummax = self._sf, self._sc


def timed_sweep(engine, grid) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.sweep(grid, engine="torch", device="cuda")
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(engine.last_sweep_stats)


def run_sweep(name: str, grid: SW.SweepGrid, want_cells: int,
              log: ShapeLog) -> dict:
    """One path of the main path: cold run with the launch counters read
    around it, a warm run on the same engine, and the comparison with the
    host columnar path."""
    engine = SW.SweepEngine()
    SF.launches = SC.launches = 0
    with log:
        cold, cold_s, cold_stats = timed_sweep(engine, grid)
    n_sf, n_sc = SF.launches, SC.launches
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
    if n_sf <= 0:
        fail(f"{name}: the sweep launched the shard_factor kernel 0 times")
    if live and n_sc <= 0:
        fail(f"{name}: the liveness sweep launched the segmented_cummax "
             f"kernel 0 times")
    if not live and n_sc != 0:
        fail(f"{name}: legacy assembly must not launch segmented_cummax")
    if warm_stats["table_cache_hits"] != warm_stats["groups"]:
        fail(f"{name}: the warm sweep rebuilt its tables")
    # a few cells against the un-memoized scalar predictor
    rng = np.random.default_rng(SEED)
    for i in rng.choice(want_cells, size=6, replace=False).tolist():
        r = cold.columns.result(i)
        rep = PL.check(
            r.arch, ShapeConfig("cell", r.seq_len, r.global_batch, r.kind),
            r.mesh_shape, backend=r.backend, grad_accum=r.grad_accum,
            remat=r.remat, optimizer=r.optimizer, chip=r.chip,
            microbatches=r.microbatches, schedule=r.schedule,
            offload_opt=r.offload, assembly=grid.assembly)
        if rep.peak_bytes != r.peak_bytes or rep.fits != r.fits:
            fail(f"{name}: cell {i} peak {r.peak_bytes} != planner.check "
                 f"{rep.peak_bytes}")
    out = {"sweep": name, "cells": want_cells, "assembly": grid.assembly,
           "meshes": len(grid.meshes()), "fit": int(cold.fit_count),
           "launches": {"shard_factor": n_sf, "segmented_cummax": n_sc},
           "cold_s": cold_s, "warm_s": warm_s, "host_numpy_s": host_s,
           "cold_cells_per_s": want_cells / cold_s,
           "warm_cells_per_s": want_cells / warm_s,
           "host_numpy_cells_per_s": want_cells / host_s,
           "cold_split": cold_stats, "warm_split": warm_stats}
    say("sweep " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 5: kernel timings at the main path's shapes
# ---------------------------------------------------------------------------


def event_ms(fn, launches: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, CUDA events around each launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(launches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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


def device_ms(fn, kernel_name: str, launches: int = 20):
    """Mean device time of the named CUDA kernel over ``launches`` calls of
    ``fn``, from a torch.profiler trace — the kernel alone, without the
    wrapper's host work that the event timing includes.  None when the
    profiler reports no device time for it (then only the event time is
    known, and the report says "not measured")."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
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


def time_kernels(log: ShapeLog, checks: dict, launches: dict) -> list:
    # the kernels once more against their plain versions, now on the very
    # operands the sweeps handed them
    dims, sizes, steps = log.sf
    deltas = log.sc
    for name, got, want in (
            ("shard_factor", SF.shard_factor_tensors(dims, sizes, steps),
             SF.shard_factor_plain(dims, sizes, steps)),
            ("segmented_cummax", SC.segmented_cummax(deltas),
             SC.segmented_cummax_plain(deltas))):
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], err)
        if err:
            fail(f"{name} kernel != plain version on the sweep's own "
                 f"operands (max abs diff {err})")
    n_dims, n = dims.shape
    n_axes = sizes.shape[0]
    sf_bytes = (n_dims + n_axes + 1) * 8 * n
    sf_ops = 4 * len(steps) * n          # mul, mod, compare, mask per step
    sf_bound = max(sf_bytes / HBM_BYTES_PER_S, sf_ops / ALU_OPS_PER_S)
    sf = {
        "name": "shard_factor", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/shard_factor.cu",
        "replaces": "src/repro/kernels/shard_factor.py:131",
        "launches": launches["shard_factor"],
        "max_abs_err": checks["shard_factor"]["max_abs_err"],
        "ms": event_ms(lambda: SF.shard_factor_tensors(dims, sizes, steps)),
        "plain_ms": event_ms(
            lambda: SF.shard_factor_plain(dims, sizes, steps)),
        "bound_ms": sf_bound * 1e3,
        "bound_by": "bytes" if sf_bytes / HBM_BYTES_PER_S
        >= sf_ops / ALU_OPS_PER_S else "operations",
        "library_ms": None,
        "device_ms": device_ms(
            lambda: SF.shard_factor_tensors(dims, sizes, steps),
            "shard_factor_kernel"),
        "shape": {"n_dims": n_dims, "n_axes": n_axes,
                  "n_steps": len(steps), "n": n},
    }
    # the path the table build really takes: numpy in, upload, launch,
    # read back (host clock, synchronised)
    d_np, s_np = dims.cpu().numpy(), sizes.cpu().numpy()

    def twin():
        out = SF.shard_factor_tensors(torch.from_numpy(d_np).to(DEV),
                                      torch.from_numpy(s_np).to(DEV), steps)
        return out.cpu().numpy()
    sf["host_roundtrip_ms"] = host_ms(twin)

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
        "ms": event_ms(lambda: SC.segmented_cummax(deltas)),
        "plain_ms": event_ms(lambda: SC.segmented_cummax_plain(deltas)),
        "bound_ms": sc_bound * 1e3,
        "bound_by": "bytes" if sc_bytes / HBM_BYTES_PER_S
        >= sc_ops / ALU_OPS_PER_S else "operations",
        "library_ms": None,
        "device_ms": device_ms(lambda: SC.segmented_cummax(deltas),
                               "segmented_cummax_kernel"),
        "shape": {"n_events": n_events, "n": m},
    }
    for k in (sf, sc):
        if not (k["ms"] > 0 and k["plain_ms"] > 0 and k["bound_ms"] > 0):
            fail(f"{k['name']}: a timing came back non-positive")
    return [sf, sc]


# ---------------------------------------------------------------------------


def main() -> int:
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

    # phase 2: kernels against their plain versions
    checks = {c["name"]: c for c in (check_shard_factor(),
                                     check_segmented_cummax())}
    say("kernels_check " + json.dumps(
        [dict(c, launches=n) for c, n in
         zip(checks.values(), (SF.launches, SC.launches))]))

    # phases 3-4: the main path
    log = ShapeLog()
    sweeps = [run_sweep("sweep_large_legacy", large_grid("legacy"),
                        124416, log),
              run_sweep("sweep_large_liveness", large_grid("liveness"),
                        124416, log),
              run_sweep("sweep_pipe_liveness", pipe_grid(), 1959552, log)]
    launches = {k: sum(s["launches"][k] for s in sweeps)
                for k in ("shard_factor", "segmented_cummax")}

    # phase 5: kernel timings at the main path's shapes
    kernels = time_kernels(log, checks, launches)
    for k in kernels:
        dev = "not measured" if k["device_ms"] is None \
            else f"{k['device_ms'] * 1e3:.1f} us"
        say(f"kernel {k['name']}: {k['ms'] * 1e3:.1f} us/call by CUDA "
            f"events (kernel alone on the device: {dev}; plain "
            f"{k['plain_ms'] * 1e3:.1f} us, bound "
            f"{k['bound_ms'] * 1e3:.3f} us by {k['bound_by']}) at "
            f"{k['shape']}, {k['launches']} launches on the main path")
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
