"""The closed loop: watch -> plan -> validate -> apply.

:class:`Autopilot` owns the current :class:`~repro_torch.core.sweep.SweepCell`
(the knobs the job is actually running), a :class:`MemoryWatch` over its
calibrated prediction, and a :class:`MitigationPlanner`.  Per step it
ingests one telemetry sample; on a DRIFT or CRITICAL verdict it ranks
mitigations and applies the best one — but only after re-validating the
mutated cell through the un-memoized :func:`repro_torch.core.planner.check`
gate: the applied plan's predicted peak must equal the reference
evaluation byte-for-byte, else :class:`MitigationError` aborts the
apply (a planner/evaluator disagreement means the memory model cannot
be trusted to steer the job).

``on_restart`` is the fault-tolerance hook: every elastic-resize or
preemption restart re-validates the (possibly new) mesh through
:func:`repro_torch.core.planner.check_parallel` and, if the watch's drift
projection no longer clears the budget, applies the top-ranked plan
before the trainer resumes.

The continual refit fits :func:`repro_torch.calibrate.learned.fit_residual`
on the observations the watch accumulated (each a
:class:`repro_torch.calibrate.measurements.Measurement`).  The
planner's reshard search runs where ``compute_engine`` / ``device`` say
(the card by default; see :mod:`.mitigation`).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from repro_torch.configs import ShapeConfig
from repro_torch.core import planner as PL
from repro_torch.core import sweep as SW
from repro_torch.core.spec import FULL_TRAIN

from .mitigation import Mitigation, MitigationPlan, MitigationPlanner
from .watch import MemoryWatch, WatchSample, WatchState


class MitigationError(RuntimeError):
    """An applied plan failed re-validation against planner.check."""


@dataclass
class Autopilot:
    """Closed-loop OOM avoidance around one training job's cell."""

    cell: SW.SweepCell
    policy: object = FULL_TRAIN
    headroom: float = PL.HEADROOM
    profile: object = None
    # learned ResidualModel applied on top of the profile (and replaced
    # in place by a continual refit)
    residual: object = None
    engine: SW.SweepEngine = field(default_factory=SW.SweepEngine)
    drift_tolerance: float = 1.05
    guard_frac: float = 0.95
    max_mitigations: int = 8
    allow_reshard: bool = True
    # continual refit (repro_torch.calibrate.learned): when enabled, every
    # usable observation accumulates into ``store`` and a persistent
    # DRIFT verdict spends a residual-model refit BEFORE a mitigation —
    # prediction bias (fragmentation, model error) is absorbed into the
    # model instead of burning a knob move on it.  A refit only fires
    # once ``refit_min_samples`` new samples arrived since the last one,
    # and at most ``max_refits`` times per run.
    refit: bool = False
    refit_min_samples: int = 8
    max_refits: int = 2
    store: object = None           # MeasurementStore (created if refit)
    # where the planner's reshard search runs (MitigationPlanner's knobs)
    compute_engine: str = "torch"
    device: Optional[str] = None

    watch: MemoryWatch = field(init=False)
    planner: MitigationPlanner = field(init=False)
    applied: list = field(default_factory=list)    # Mitigation log
    events: list = field(default_factory=list)     # (step, kind, detail)
    refits: int = field(default=0, init=False)
    _fitted_n: int = field(default=0, init=False)

    def __post_init__(self):
        self.planner = MitigationPlanner(
            engine=self.engine, policy=self.policy,
            headroom=self.headroom, profile=self.profile,
            residual=self.residual, compute_engine=self.compute_engine,
            device=self.device)
        self.watch = MemoryWatch(
            predicted_bytes=self._predict(self.cell),
            budget_bytes=self.budget_bytes,
            drift_tolerance=self.drift_tolerance,
            guard_frac=self.guard_frac)
        if self.refit:
            if getattr(self.cell, "serve", None) is not None:
                raise ValueError(
                    "continual refit supports train cells only (a serve "
                    "spec is not representable as a calibrate "
                    "Measurement)")
            if self.store is None:
                from repro_torch.calibrate.measurements import MeasurementStore
                self.store = MeasurementStore()
            self.watch.store = self.store
            self.watch.measurement_of = self._measurement_of

    # -- predictions ---------------------------------------------------------
    @property
    def budget_bytes(self) -> int:
        return int(PL.chip_hbm(self.cell.chip) * self.headroom)

    @property
    def predicted_bytes(self) -> int:
        return self.watch.predicted_bytes

    def _predict(self, cell: SW.SweepCell) -> int:
        return self.engine.evaluate(cell, policy=self.policy,
                                    headroom=self.headroom,
                                    profile=self.profile,
                                    residual=self.residual).peak_bytes

    def _measurement_of(self, step: int, observed: int):
        """One watch observation as a calibrate Measurement of the
        CURRENT cell — the continual-refit sample the store accumulates.
        """
        from repro_torch.calibrate.measurements import Measurement
        c = self.cell
        pname = next((k for k, v in SW.POLICIES.items()
                      if v == self.policy), "full")
        return Measurement(
            arch=c.arch, kind=c.kind, seq_len=c.seq_len,
            global_batch=c.global_batch, mesh_shape=c.mesh_shape,
            measured_bytes=int(observed), backend=c.backend, chip=c.chip,
            optimizer=c.optimizer, remat=c.remat,
            grad_accum=c.grad_accum, policy=pname,
            microbatches=c.microbatches, schedule=c.schedule,
            offload_optimizer=c.offload,
            source=f"autopilot:step{int(step)}")

    # -- the loop ------------------------------------------------------------
    def observe(self, step: int, observed) -> WatchSample:
        """Ingest one telemetry sample; refit, then mitigate, when the
        budget is threatened.  ``observed`` is bytes, a dryrun record
        dict, or None.

        Any DRIFT verdict (ewma-only or guard-band) first tries a
        residual-model refit when the continual-refit gate passes —
        persistent drift is prediction bias first, and a refit that
        absorbs it both fixes the forecast and often clears the guard
        band without spending a knob move.  The threat is re-projected
        under the refreshed prediction; a mitigation fires only if the
        projection STILL violates the guard band.  CRITICAL skips
        straight to mitigation — there is no time to refit when the
        next allocation spike is an OOM abort."""
        sample = self.watch.observe(step, observed)
        if sample.state in (WatchState.DRIFT, WatchState.CRITICAL):
            self.events.append((int(step), sample.state.value,
                                sample.projected_bytes))
            threatened = (sample.state is WatchState.CRITICAL
                          or sample.projected_bytes
                          > self.guard_frac * self.budget_bytes)
            if sample.state is WatchState.DRIFT \
                    and self._maybe_refit(step):
                projected = int(self.watch.ewma_ratio
                                * self.watch.predicted_bytes)
                threatened = (projected
                              > self.guard_frac * self.budget_bytes)
            if threatened:
                self.mitigate(step, self.watch.ewma_ratio)
        return sample

    def _maybe_refit(self, step: int) -> bool:
        """Refit the residual model from the accumulated store when the
        gate passes (refit enabled, refit budget left, enough NEW
        samples since the last fit); True when a refit was applied."""
        if not self.refit or self.store is None:
            return False
        if self.refits >= self.max_refits:
            return False
        if len(self.store) - self._fitted_n < self.refit_min_samples:
            return False
        from repro_torch.calibrate.learned import fit_residual
        try:
            model = fit_residual(self.store, profile=self.profile,
                                 engine=self.engine)
        except ValueError:
            return False
        self._fitted_n = len(self.store)
        self.refits += 1
        self.residual = model
        self.planner.residual = model
        # the EWMA resets: the old ratio measured the bias the refit
        # just absorbed into the model
        self.watch.repredict(self._predict(self.cell), reset_ewma=True)
        self.events.append((int(step), "refit",
                            self.watch.predicted_bytes))
        return True

    def mitigate(self, step: int,
                 ewma_ratio: Optional[float] = None) -> Optional[Mitigation]:
        """Rank mitigations for the current cell and apply the best one
        (validated).  No-op once ``max_mitigations`` moves were spent —
        the autopilot never thrashes knobs forever."""
        if len(self.applied) >= self.max_mitigations:
            self.events.append((int(step), "exhausted",
                                len(self.applied)))
            return None
        ratio = self.watch.ewma_ratio if ewma_ratio is None else ewma_ratio
        plan = self.planner.plan(self.cell, ewma_ratio=ratio,
                                 allow_reshard=self.allow_reshard)
        best = plan.best
        if best is None:
            self.events.append((int(step), "no-candidates", 0))
            return None
        self._apply(step, best)
        return best

    def _apply(self, step: int, m: Mitigation) -> None:
        """Re-validate ``m`` against the un-memoized planner gate, then
        make its cell the current one and re-point the watch."""
        c = m.cell
        shape = ShapeConfig("autopilot", c.seq_len, c.global_batch,
                            c.kind)
        ref = PL.check(c.arch, shape, c.mesh_shape, policy=self.policy,
                       backend=c.backend, grad_accum=c.grad_accum,
                       remat=c.remat, optimizer=c.optimizer, chip=c.chip,
                       headroom=self.headroom, profile=self.profile,
                       microbatches=c.microbatches, schedule=c.schedule,
                       serve=c.serve, offload_opt=c.offload,
                       residual=self.residual)
        if ref.peak_bytes != m.predicted_bytes:
            raise MitigationError(
                f"mitigation {m.action!r} failed validation: planner."
                f"check predicts {ref.peak_bytes} bytes for the mutated "
                f"cell but the plan claimed {m.predicted_bytes}")
        self.cell = c
        self.applied.append(m)
        self.events.append((int(step), f"apply:{m.action}",
                            m.predicted_bytes))
        # keep the EWMA: the drift multiplier (fragmentation, model
        # error) is a property of the JOB, not of the knobs — observed
        # usage scales with the new prediction, so the ratio carries over
        self.watch.repredict(m.predicted_bytes, reset_ewma=False)

    # -- fault-tolerance hook ------------------------------------------------
    def on_restart(self, step: int = -1,
                   mesh_shape: Optional[dict] = None) -> SW.SweepCell:
        """Restart/elastic-resize hook: re-validate the mesh through
        planner.check_parallel (a resize onto an illegal mesh must fail
        loudly here, not as a silent misprediction), adopt it, and if
        the drift projection no longer clears the budget apply the
        top-ranked plan before the trainer resumes."""
        cfg, _, _ = self.engine._arch_state(self.cell.arch, self.policy)
        mesh = dict(mesh_shape) if mesh_shape is not None \
            else self.cell.mesh_shape
        PL.check_parallel(cfg, mesh, self.cell.kind, self.cell.seq_len)
        if mesh_shape is not None and mesh != self.cell.mesh_shape:
            self.cell = replace(self.cell,
                                mesh=tuple(sorted(mesh.items())))
            self.watch.repredict(self._predict(self.cell),
                                 reset_ewma=False)
            self.events.append((int(step), "resize",
                                self.watch.predicted_bytes))
        projected = int(self.watch.ewma_ratio * self.watch.predicted_bytes)
        if projected > self.guard_frac * self.budget_bytes:
            self.mitigate(step)
        return self.cell
