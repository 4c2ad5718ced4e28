"""OoM guard + configuration planner — the paper's purpose, closed-loop.

``check`` predicts a cell's peak per-device memory BEFORE any compile or
launch and compares it to the chip's HBM, using only Eq.1 arithmetic.
``plan`` searches the cheap knobs (gradient accumulation, remat policy)
for the first configuration that fits.  For searches over the FULL knob
space (mesh factorizations x optimizer x remat x accum x batch x seq_len
x chip), use the vectorized/memoized engine in
:mod:`repro_torch.core.sweep`, which ``plan`` delegates to; the user's
questions — the smallest pod (``plan_min_chips``), the largest batch per
pod (``plan_frontier``), the most concurrent sequences per replica
(``plan_max_concurrency``) and the replicas for N QPS (``plan_replicas``)
— are answered through the pruned searches of
:mod:`repro_torch.core.search`, whose sliced sweeps run on the card
(``compute_engine="torch"``, ``device="cuda"``) unless the caller asks
for the host (``compute_engine="numpy"`` or ``device="cpu"``).

This is also where arctic-480b's published memory plan comes from: Adam's
fp32 states alone (~5.2 TiB) can never fit a 256-chip v5e pod, which the
guard flags analytically (``adam_state_bytes``).

Every entry point takes a calibration profile (``profile=``, a
:class:`repro_torch.calibrate.profile.CalibrationProfile`); ``check`` and
``plan`` also take a learned residual model (``residual=``,
:class:`repro_torch.calibrate.learned.ResidualModel`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core import factors as F
from repro_torch.core import predictor as PR
from repro_torch.core.spec import FULL_TRAIN, TrainPolicy

GiB = 1024 ** 3


# ---------------------------------------------------------------------------
# chip catalogue: per-device HBM for the accelerators the planner targets.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_bytes: int
    vendor: str = "google"

    @property
    def hbm_gib(self) -> float:
        return self.hbm_bytes / GiB


CHIPS: dict[str, ChipSpec] = {
    "v5e": ChipSpec("v5e", 16 * GiB),
    "v5p": ChipSpec("v5p", 95 * GiB),
    "v6e": ChipSpec("v6e", 32 * GiB),
    "a100-40g": ChipSpec("a100-40g", 40 * GiB, vendor="nvidia"),
    "a100-80g": ChipSpec("a100-80g", 80 * GiB, vendor="nvidia"),
    "h100": ChipSpec("h100", 80 * GiB, vendor="nvidia"),
    "h200": ChipSpec("h200", 141 * GiB, vendor="nvidia"),
}

V5E_HBM = CHIPS["v5e"].hbm_bytes      # backward-compat alias
# The runtime reserves working space; plan against a fraction of physical HBM.
HEADROOM = 0.92


def chip_hbm(chip: str) -> int:
    if chip not in CHIPS:
        raise KeyError(f"unknown chip {chip!r}; known: {sorted(CHIPS)}")
    return CHIPS[chip].hbm_bytes


@dataclass
class PlanReport:
    arch: str
    shape: str
    fits: bool
    peak_bytes: int
    budget_bytes: int
    grad_accum: int = 1
    remat: str = "block"
    note: str = ""
    prediction: Optional[PR.PredictedMemory] = None

    def __str__(self) -> str:
        verdict = "FITS" if self.fits else "OOM "
        return (f"[{verdict}] {self.arch} x {self.shape}: "
                f"peak {self.peak_bytes / GiB:.2f} GiB vs budget "
                f"{self.budget_bytes / GiB:.2f} GiB"
                + (f" (grad_accum={self.grad_accum}, remat={self.remat})"
                   if self.grad_accum > 1 else "")
                + (f" — {self.note}" if self.note else ""))


def check_parallel(cfg, mesh_shape: dict, kind: str,
                   seq_len: Optional[int] = None) -> None:
    """Reject parallelism plans the architecture / step kind cannot run.

    The ONE validation gate for the `expert` (ep) and `context` (cp)
    mesh axes — ``make_context`` (every per-cell path) and the columnar
    sweep (grid-level, ``SweepGrid.check_parallel``) both call it, so
    invalid combos fail with the same clean ValueError everywhere
    instead of a silent misprediction or a deep traceback:

    * ``expert`` axis on an arch without MoE layers (nothing to shard);
    * ``expert`` degree beyond — or not dividing — the routed-expert
      count (the EP all_to_all needs equal per-shard expert groups; a
      non-divisible axis would be silently inert in the model and
      unrunnable by the runtime);
    * ``context`` axis on a decode step (token-at-a-time: no seq dim to
      ring over — decode KV caches stay on `cache_seq`);
    * ``context`` degree that does not divide the sequence length (ring
      attention needs equal per-shard blocks; unlike head counts there
      is no graceful-replication story for a lopsided ring).
    """
    from repro_torch.launch import mesh as M
    ep, cp = M.ep_degree(mesh_shape), M.cp_degree(mesh_shape)
    if ep > 1:
        if cfg.moe is None:
            raise ValueError(
                f"expert-parallel mesh axis (expert={ep}) on dense arch "
                f"{cfg.name!r}: no MoE layers to shard — drop the expert "
                f"axis or pick an MoE architecture")
        if ep > cfg.moe.n_experts:
            raise ValueError(
                f"expert={ep} exceeds {cfg.name!r}'s "
                f"{cfg.moe.n_experts} routed experts; cap the axis with "
                f"--max-expert {cfg.moe.n_experts} or shrink the mesh")
        if cfg.moe.n_experts % ep:
            raise ValueError(
                f"expert={ep} does not divide {cfg.name!r}'s "
                f"{cfg.moe.n_experts} routed experts: the EP all_to_all "
                f"needs equal per-shard expert groups (a non-divisible "
                f"axis would be silently inert in the memory model and "
                f"unrunnable by the shard_map runtime)")
    if cp > 1:
        if kind == "decode":
            raise ValueError(
                f"context-parallel mesh axis (context={cp}) is invalid "
                f"for decode: a token-at-a-time step has no sequence dim "
                f"to ring over (decode KV caches shard via cache_seq "
                f"instead)")
        if seq_len is not None and seq_len % cp:
            raise ValueError(
                f"context={cp} does not divide seq_len {seq_len}: ring "
                f"attention needs equal per-shard sequence blocks — use "
                f"a divisible seq_len or a smaller context axis")


def check_serve(cfg, serve, kind: str) -> None:
    """Reject serving-fleet knobs the step kind / registry cannot honor.

    The serve twin of :func:`check_parallel` — ``make_context`` (every
    per-cell path), ``SweepGrid.check_serve`` (grid-level, both sweep
    modes) and the sweep CLI all route through it, so invalid serve
    plans fail with one clean ValueError everywhere.  Range errors
    (hit rate outside [0,1], utilization outside (0,1], non-page-aligned
    block sizes) are rejected even earlier, at ServeSpec construction.

    * any active serve knob on a train kind (the block pool, prefix
      cache, request mix and draft model are serving-runtime concepts —
      a train step has no KV pool to page);
    * a draft model on a non-decode kind (speculative decoding drafts
      ahead of the decode loop only);
    * a draft arch that is not in the config registry.
    """
    if serve is None or serve.is_neutral:
        return
    if kind == "train":
        raise ValueError(
            f"serve knobs (block_size/utilization/prefix-hit-rate/mix/"
            f"draft) are invalid for kind 'train': a train step has no "
            f"KV pool to page — drop them or sweep a serve kind")
    if serve.draft_arch:
        if kind != "decode":
            raise ValueError(
                f"draft_arch {serve.draft_arch!r} is invalid for kind "
                f"{kind!r}: speculative decoding is a decode-time "
                f"technique — drop the draft or use kind 'decode'")
        from repro_torch.configs import registered_archs
        from repro_torch.core.sweep import normalize_arch
        known = registered_archs()
        try:
            name = normalize_arch(serve.draft_arch)
        except KeyError:
            name = None
        if name not in known:
            raise ValueError(
                f"unknown draft arch {serve.draft_arch!r}; known: "
                f"{sorted(known)}")


def check_offload(kind: str, offload_opt: bool) -> None:
    """Reject the optimizer-offload knob on step kinds that hold no
    optimizer state.  The offload twin of :func:`check_parallel` /
    :func:`check_serve` — ``make_context`` (every per-cell path),
    ``SweepGrid.check_offload`` (grid-level, both sweep modes) and the
    sweep CLI all route through it."""
    if offload_opt and kind != "train":
        raise ValueError(
            f"--offload-optimizer is invalid for kind {kind!r}: serve "
            f"steps hold no optimizer state to offload — drop the knob "
            f"or sweep kind 'train'")


def make_context(cfg, mesh_shape: dict, *, kind: str, global_batch: int,
                 seq_len: int, backend: str = "tpu", grad_accum: int = 1,
                 remat: Optional[str] = None,
                 optimizer: Optional[str] = None,
                 microbatches: int = 1,
                 schedule: str = "1f1b",
                 serve=None, offload_opt: bool = False) -> F.PredictContext:
    """The ONE place a planner/sweep cell becomes a PredictContext — the
    sweep engine and ``check`` share it, so their predictions can never
    diverge on context construction.  The pipeline degree comes from the
    mesh's ``pipe`` axis; ``microbatches``/``schedule`` set how the batch
    fills that pipeline (inert when the mesh has no pipe axis); the
    `expert`/`context` axes are validated against the arch and step kind
    (``check_parallel``); serving-fleet knobs (``serve``, a
    repro_torch.serve.pool.ServeSpec) are validated by ``check_serve`` and a
    fully-neutral spec is normalized to None, so neutral serve cells are
    bit-identical to pre-serve predictions (and hit the same memo keys).
    """
    from repro_torch.core.stages import SCHEDULES
    from repro_torch.launch import mesh as M
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {schedule!r}; known: {SCHEDULES}")
    check_parallel(cfg, mesh_shape, kind, seq_len)
    check_serve(cfg, serve, kind)
    check_offload(kind, offload_opt)
    if serve is not None and serve.is_neutral:
        serve = None
    opt = optimizer or cfg.optimizer
    return F.PredictContext(
        mesh_shape=mesh_shape, rules=M.arch_rules(cfg, kind),
        optimizer=opt, fsdp=cfg.fsdp, master_fp32=opt != "adafactor",
        remat=remat or cfg.remat, backend=backend,
        global_batch=global_batch, seq_len=seq_len,
        enc_seq=int(seq_len * cfg.encdec.enc_seq_ratio)
        if cfg.encdec else 0,
        kind=kind, max_len=seq_len, grad_accum=grad_accum,
        pp=M.pp_degree(mesh_shape), microbatches=microbatches,
        schedule=schedule, serve=serve, offload_opt=offload_opt)


def _resolve_shape(shape):
    """Accept a registered shape name or an ad-hoc ShapeConfig."""
    from repro_torch.configs import SHAPES, ShapeConfig
    if isinstance(shape, ShapeConfig):
        return shape
    return SHAPES[shape]


def check(arch: str, shape_name, mesh_shape: dict,
          hbm_bytes: Optional[int] = None, policy: TrainPolicy = FULL_TRAIN,
          backend: str = "tpu", grad_accum: int = 1,
          remat: Optional[str] = None, optimizer: Optional[str] = None,
          chip: str = "v5e", headroom: float = HEADROOM,
          profile=None, microbatches: int = 1,
          schedule: str = "1f1b", serve=None,
          offload_opt: bool = False,
          assembly: str = "legacy", residual=None) -> PlanReport:
    """Reference single-cell evaluation: fresh build, no caches.

    ``shape_name`` may be a registered shape name ("train_4k") or a
    ShapeConfig; ``hbm_bytes`` overrides the ``chip`` lookup when given;
    ``profile`` (a repro_torch.calibrate CalibrationProfile) corrects the
    prediction with measurement-fitted per-term coefficients + the
    ``chip`` constant, and ``residual`` (a repro_torch.calibrate.learned
    ResidualModel) adds the learned per-family correction on top.  A
    mesh with a ``pipe`` axis is evaluated per-pipeline-stage
    (core.stages) and the worst stage reported.
    ``assembly="liveness"`` checks against the interval-overlap peak
    (core.liveness) instead of the Eq.1 sum-of-maxima.
    """
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch)
    shape = _resolve_shape(shape_name)
    model = build_model(cfg)
    ctx = make_context(cfg, mesh_shape, kind=shape.kind,
                       global_batch=shape.global_batch,
                       seq_len=shape.seq_len, backend=backend,
                       grad_accum=grad_accum, remat=remat,
                       optimizer=optimizer, microbatches=microbatches,
                       schedule=schedule, serve=serve,
                       offload_opt=offload_opt)
    pred = PR.predict(model, policy, ctx, profile=profile, chip=chip,
                      assembly=assembly)
    if residual is not None:
        from repro_torch.calibrate.learned import apply_residual
        pred = apply_residual(pred, residual, cfg.family, ctx,
                              profile=profile)
    budget = int((hbm_bytes if hbm_bytes is not None
                  else chip_hbm(chip)) * headroom)
    return PlanReport(arch=arch, shape=shape.name,
                      fits=pred.peak_bytes <= budget,
                      peak_bytes=pred.peak_bytes, budget_bytes=budget,
                      grad_accum=grad_accum, remat=remat or cfg.remat,
                      prediction=pred)


def plan(arch: str, shape_name, mesh_shape: dict,
         hbm_bytes: Optional[int] = None, policy: TrainPolicy = FULL_TRAIN,
         backend: str = "tpu", chip: str = "v5e",
         headroom: float = HEADROOM, engine=None,
         profile=None, assembly: str = "legacy",
         residual=None) -> PlanReport:
    """First-fit search over (remat, grad_accum); pure arithmetic.

    Delegates to the memoized sweep engine so the candidate evaluations
    share the parsed model and the batch-independent factor sums; pass
    ``engine`` (a SweepEngine) to share those caches across calls,
    ``profile`` to plan against calibrated predictions (plus
    ``residual`` for the learned per-family correction), and
    ``assembly="liveness"`` to plan against the interval-overlap peak.
    """
    from repro_torch.core import sweep as SW
    from repro_torch.configs import get_config

    shape = _resolve_shape(shape_name)
    budget = int((hbm_bytes if hbm_bytes is not None
                  else chip_hbm(chip)) * headroom)
    engine = engine or SW.SweepEngine()
    base = engine.report(arch, shape, mesh_shape, policy=policy,
                         backend=backend, budget_bytes=budget,
                         chip=chip, profile=profile, assembly=assembly,
                         residual=residual)
    if base.fits or shape.kind != "train":
        return base
    cfg = get_config(arch)
    for remat in dict.fromkeys((cfg.remat, "block")):
        for accum in (1, 2, 4, 8, 16, 32):
            if shape.global_batch % accum:
                continue
            r = engine.report(arch, shape, mesh_shape, policy=policy,
                              backend=backend, budget_bytes=budget,
                              grad_accum=accum, remat=remat,
                              chip=chip, profile=profile,
                              assembly=assembly, residual=residual)
            if r.fits:
                r.note = f"planner: accum x{accum} fits the budget"
                return r
    base.note = ("no (remat, grad_accum) configuration fits — needs a "
                 "bigger mesh, more sharding, or a leaner optimizer")
    return base


def _search_grid(arch: str, shape, chips, chip, policy, backend,
                 headroom, allow_pp, max_pp, allow_ep, max_ep, allow_cp,
                 max_cp, microbatches, schedules, profile,
                 global_batches=None):
    """The (mesh x knob) grid plan_min_chips / plan_frontier search,
    with the illegal expert/context factorizations FILTERED out (None
    when nothing legal remains)."""
    from repro_torch.core import sweep as SW
    from repro_torch.configs import get_config
    axes: tuple = ("data", "model")
    max_axis: dict = {}
    if allow_ep:
        axes += ("expert",)
        max_axis["expert"] = max_ep
    if allow_cp:
        axes += ("context",)
        max_axis["context"] = max_cp
    if allow_pp:
        axes += ("pipe",)
        max_axis["pipe"] = max_pp
    grid = SW.SweepGrid(
        arch=arch, chips=tuple(chips), mesh_axes=axes,
        max_axis=max_axis or None, chip=chip,
        microbatches=tuple(microbatches) if allow_pp else (1,),
        schedules=tuple(schedules) if allow_pp else ("1f1b",),
        global_batches=tuple(global_batches) if global_batches is not None
        else (shape.global_batch,),
        seq_lens=(shape.seq_len,),
        kind=shape.kind, policy=policy, backend=backend,
        headroom=headroom, profile=profile)
    if allow_ep or allow_cp:
        cfg = get_config(SW.normalize_arch(arch))

        def legal(mesh: dict) -> bool:
            try:
                check_parallel(cfg, mesh, shape.kind, shape.seq_len)
                return True
            except ValueError:
                return False

        meshes = [m for m in grid.meshes() if legal(m)]
        if not meshes:
            return None
        grid.mesh_shapes = meshes
    return grid


def plan_min_chips(arch: str, shape_name, chips=(4, 8, 16, 32, 64),
                   chip: str = "v5e", policy: TrainPolicy = FULL_TRAIN,
                   backend: str = "tpu", headroom: float = HEADROOM,
                   allow_pp: bool = True, max_pp: int = 8,
                   allow_ep: bool = False, max_ep: int = 8,
                   allow_cp: bool = False, max_cp: int = 8,
                   microbatches=(1, 4, 8), schedules=("1f1b", "gpipe"),
                   profile=None, engine=None, search: str = "pruned",
                   stats=None, compute_engine: str = "torch",
                   device=None):
    """Smallest chip count that fits the shape, pipeline parallelism
    allowed: sweeps every (data, model[, expert][, context][, pipe])
    factorization of each candidate chip count x microbatch count x
    schedule and returns the Pareto-min
    :class:`~repro_torch.core.sweep.SweepResult` (None if nothing fits).
    ``allow_pp=False`` restricts to the 2-axis plans, so
    ``plan_min_chips(...) vs plan_min_chips(..., allow_pp=False)``
    quantifies what the pipe axis buys; ``allow_ep=True`` and
    ``allow_cp=True`` add the expert and context axes the same way.

    This is a SEARCH, so unlike an explicit ``planner.check`` mesh the
    enumerated factorizations that :func:`check_parallel` would reject
    (an expert degree beyond the arch's routed experts — or any expert
    degree > 1 on a dense arch — and context degrees that don't divide
    the shape's seq_len or that land on a decode shape) are simply
    FILTERED out of the candidate set rather than aborting the whole
    search; the remaining legal plans are swept and the Pareto-min
    returned (None when nothing fits or nothing is legal).

    ``search="pruned"`` (default) answers through
    :func:`repro_torch.core.search.min_chips_search` — statics-floor bounds
    prune hopeless chip counts and the scan stops at the first feasible
    count, returning an answer IDENTICAL to the exhaustive reduction
    (``search="exhaustive"``, the pre-pruner behaviour) at a fraction
    of the cells; pass a :class:`repro_torch.core.search.SearchStats` as
    ``stats`` to see the work accounting.  The slices run on the torch
    engine on ``device`` (``"cuda"`` when None); ``compute_engine=
    "numpy"`` runs them on the host columnar path."""
    from repro_torch.core import search as SR
    from repro_torch.core import sweep as SW
    shape = _resolve_shape(shape_name)
    grid = _search_grid(arch, shape, chips, chip, policy, backend,
                        headroom, allow_pp, max_pp, allow_ep, max_ep,
                        allow_cp, max_cp, microbatches, schedules,
                        profile)
    if grid is None:
        return None
    engine = engine or SW.SweepEngine()
    if search == "exhaustive":
        return engine.sweep(grid, engine=compute_engine,
                            device=device).min_chips()
    if search != "pruned":
        raise ValueError(f"search must be 'pruned' or 'exhaustive', "
                         f"got {search!r}")
    return SR.min_chips_search(grid, engine=engine, stats=stats,
                               compute_engine=compute_engine, device=device)


def plan_frontier(arch: str, shape_name, chips=(4, 8, 16, 32, 64),
                  global_batches=None, chip: str = "v5e",
                  policy: TrainPolicy = FULL_TRAIN, backend: str = "tpu",
                  headroom: float = HEADROOM,
                  allow_pp: bool = True, max_pp: int = 8,
                  allow_ep: bool = False, max_ep: int = 8,
                  allow_cp: bool = False, max_cp: int = 8,
                  microbatches=(1, 4, 8), schedules=("1f1b", "gpipe"),
                  profile=None, engine=None, search: str = "pruned",
                  stats=None, compute_engine: str = "torch",
                  device=None) -> list:
    """(n_chips, max fitting global batch) frontier over the same plan
    space as :func:`plan_min_chips`, swept across ``global_batches``
    (default: powers of two down from the shape's batch).  The pruned
    search scans each chip count's batch axis descending and stops at
    the first fit — identical answers to the exhaustive
    ``SweepResults.frontier()`` (cross-checked in tests) without paying
    for the cells below each frontier point.  ``compute_engine`` and
    ``device`` as in :func:`plan_min_chips`."""
    from repro_torch.core import search as SR
    from repro_torch.core import sweep as SW
    shape = _resolve_shape(shape_name)
    if global_batches is None:
        gb, global_batches = shape.global_batch, []
        while gb >= 1:
            global_batches.append(gb)
            if gb == 1:
                break
            gb //= 2
    grid = _search_grid(arch, shape, chips, chip, policy, backend,
                        headroom, allow_pp, max_pp, allow_ep, max_ep,
                        allow_cp, max_cp, microbatches, schedules,
                        profile, global_batches=tuple(global_batches))
    if grid is None:
        return []
    engine = engine or SW.SweepEngine()
    if search == "exhaustive":
        return engine.sweep(grid, engine=compute_engine,
                            device=device).frontier()
    if search != "pruned":
        raise ValueError(f"search must be 'pruned' or 'exhaustive', "
                         f"got {search!r}")
    return SR.frontier_search(grid, engine=engine, stats=stats,
                              compute_engine=compute_engine, device=device)


@dataclass
class ConcurrencyReport:
    """Answer to "max concurrent sequences per replica on chip X"."""

    arch: str
    chip: str
    mesh_shape: dict
    kind: str
    seq_len: int
    max_concurrency: int          # 0 when even one sequence OOMs
    peak_bytes: int               # peak at max_concurrency (or at 1 if 0)
    budget_bytes: int
    serve: Optional[object] = None

    def __str__(self) -> str:
        return (f"{self.arch} on {self.chip} x {self.mesh_shape}: "
                f"{self.max_concurrency} concurrent seqs @ "
                f"{self.seq_len} tokens ({self.peak_bytes / GiB:.2f} / "
                f"{self.budget_bytes / GiB:.2f} GiB)")


def plan_max_concurrency(arch: str, seq_len: int,
                         mesh_shape: Optional[dict] = None,
                         chip: str = "v5e", kind: str = "decode",
                         serve=None, backend: str = "tpu",
                         policy: TrainPolicy = FULL_TRAIN,
                         headroom: float = HEADROOM, cap: int = 65536,
                         profile=None, engine=None,
                         stats=None) -> ConcurrencyReport:
    """Max concurrent sequences one replica sustains on ``chip``.  Each
    probe is one memoized scalar evaluation (``SweepEngine.report``, on
    the host).  Peak bytes are monotone nondecreasing in the
    concurrency along batches aligned to the mesh's shard product
    (every gb-bearing term has a nonnegative coefficient at a FIXED
    mesh, and at aligned batches the shard denominators are maximal),
    so :func:`repro_torch.core.search.monotone_max` brackets the answer with
    a galloping + binary search over the aligned ladder and resolves
    the final window exactly — unlike a naive binary search over raw
    integers, this stays exact on batch-sharded meshes (``data > 1``),
    where peak(gb) is NOT monotone off the ladder."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import search as SR
    from repro_torch.core import sweep as SW
    engine = engine or SW.SweepEngine()
    mesh_shape = dict(mesh_shape or {"data": 1, "model": 1})
    budget = int(chip_hbm(chip) * headroom)

    def peak(gb: int) -> int:
        shape = ShapeConfig("concurrency", seq_len, gb, kind)
        rep = engine.report(arch, shape, mesh_shape, policy=policy,
                            backend=backend, budget_bytes=budget,
                            chip=chip, profile=profile, serve=serve)
        return rep.peak_bytes

    best = SR.max_concurrency_search(peak, budget, cap,
                                     mesh_shape=mesh_shape, stats=stats)
    return ConcurrencyReport(
        arch=arch, chip=chip, mesh_shape=mesh_shape, kind=kind,
        seq_len=seq_len, max_concurrency=best,
        peak_bytes=peak(best if best else 1),
        budget_bytes=budget, serve=serve)


@dataclass
class FleetReport:
    """Answer to "replicas needed for N QPS at p99 context length"."""

    arch: str
    chip: str
    mesh_shape: dict
    qps: float
    latency_s: float
    seq_len: int                  # plan at the p99 context length
    concurrent_requests: int      # Little's law: ceil(qps * latency)
    per_replica: int              # plan_max_concurrency answer
    replicas: int
    chips_per_replica: int
    total_chips: int
    serve: Optional[object] = None

    def __str__(self) -> str:
        return (f"{self.arch}: {self.qps:g} QPS x {self.latency_s:g}s = "
                f"{self.concurrent_requests} in flight / {self.per_replica}"
                f" per replica -> {self.replicas} replicas "
                f"({self.total_chips} x {self.chip})")


def plan_replicas(arch: str, qps: float, seq_len: int,
                  latency_s: float = 10.0,
                  mesh_shape: Optional[dict] = None, chip: str = "v5e",
                  kind: str = "decode", serve=None, backend: str = "tpu",
                  policy: TrainPolicy = FULL_TRAIN,
                  headroom: float = HEADROOM, profile=None,
                  engine=None) -> FleetReport:
    """Replicas needed to serve ``qps`` at the p99 context ``seq_len``.
    Little's law sizes the in-flight population
    (``L = qps x latency``); :func:`plan_max_concurrency` sizes one
    replica; the fleet is the ceiling of the quotient."""
    import math
    from repro_torch.launch import mesh as M
    if qps <= 0 or latency_s <= 0:
        raise ValueError(
            f"qps ({qps}) and latency_s ({latency_s}) must be positive")
    per = plan_max_concurrency(arch, seq_len, mesh_shape=mesh_shape,
                               chip=chip, kind=kind, serve=serve,
                               backend=backend, policy=policy,
                               headroom=headroom, profile=profile,
                               engine=engine)
    if per.max_concurrency == 0:
        raise ValueError(
            f"{arch} cannot serve even one {seq_len}-token sequence on "
            f"{chip} x {per.mesh_shape} (peak "
            f"{per.peak_bytes / GiB:.2f} GiB vs budget "
            f"{per.budget_bytes / GiB:.2f} GiB) — use a bigger mesh or "
            f"chip")
    concurrent = max(math.ceil(qps * latency_s), 1)
    replicas = -(-concurrent // per.max_concurrency)
    chips = M.mesh_chips(per.mesh_shape)
    return FleetReport(
        arch=arch, chip=chip, mesh_shape=per.mesh_shape, qps=qps,
        latency_s=latency_s, seq_len=seq_len,
        concurrent_requests=concurrent, per_replica=per.max_concurrency,
        replicas=replicas, chips_per_replica=chips,
        total_chips=replicas * chips, serve=serve)


def adam_state_bytes(arch: str) -> int:
    """Analytic Adam fp32 state (m+v+master) for the full model — the
    arctic-480b infeasibility argument."""
    from repro_torch.configs import get_config
    from repro_torch.core.parser import parse_model, total_params
    from repro_torch.models import build_model
    n = total_params(parse_model(build_model(get_config(arch)).spec,
                                 FULL_TRAIN))
    return n * 12
