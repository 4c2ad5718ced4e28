"""OoM guard — the paper's purpose, closed-loop.

``check`` predicts a cell's peak per-device memory BEFORE any compile or
launch and compares it to the chip's HBM, using only Eq.1 arithmetic.
For searches over the FULL knob space (mesh factorizations x optimizer x
remat x accum x batch x seq_len x chip), use the vectorized/memoized
engine in :mod:`repro_torch.core.sweep`.  The first-fit planner and the
Pareto plan queries are not ported yet.
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
    ShapeConfig; ``hbm_bytes`` overrides the ``chip`` lookup when given.
    Calibration (``profile``, ``residual``) is not ported yet and is
    rejected.  A mesh with a ``pipe`` axis is evaluated per-pipeline-stage
    (core.stages) and the worst stage reported.
    ``assembly="liveness"`` checks against the interval-overlap peak
    (core.liveness) instead of the Eq.1 sum-of-maxima.
    """
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    if profile is not None or residual is not None:
        raise NotImplementedError(
            "calibration profiles / residual models are not ported yet "
            "(the calibrate package is missing); pass profile=None, "
            "residual=None")
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
    pred = PR.predict(model, policy, ctx, chip=chip, assembly=assembly)
    budget = int((hbm_bytes if hbm_bytes is not None
                  else chip_hbm(chip)) * headroom)
    return PlanReport(arch=arch, shape=shape.name,
                      fits=pred.peak_bytes <= budget,
                      peak_bytes=pred.peak_bytes, budget_bytes=budget,
                      grad_accum=grad_accum, remat=remat or cfg.remat,
                      prediction=pred)
