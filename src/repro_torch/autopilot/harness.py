"""Synthetic OOM-trajectory harness: guarded vs unguarded trainer runs.

Each :class:`DriftScenario` is a per-step *drift ratio* trajectory —
the factor by which true device usage exceeds the Eq.1 prediction of
the cell the job is currently running (allocator fragmentation, model
error, an unmodelled resident buffer...).  True usage therefore tracks
the cell: a mitigation that shrinks the predicted peak shrinks real
usage by the same factor, exactly the physical contract the autopilot
steers by.

The harness normalizes the chip budget so the base cell starts at
``BASE_FRAC`` of it (arch-independent trajectories), then drives
:class:`~repro_torch.runtime.fault_tolerance.ResilientTrainer` with

* a failure injector that raises an injected OOM whenever true usage
  exceeds the budget, and
* (guarded only) an :class:`~repro_torch.autopilot.guard.Autopilot` observing
  the same usage BEFORE each step — admission control, so a mitigation
  lands before the allocation that would have died.

Unguarded runs keep the base cell: once the trajectory crosses the
budget every retry fails at the same step, the consecutive-failure
budget exhausts, and the run aborts.  Guarded runs must complete every
scenario with zero injected OOMs.

Every :class:`ScenarioResult` field equals the reference's for the same
scenario and chip.  The trainer's checkpoints go to a temporary
directory that is removed when the run ends.
"""

from __future__ import annotations

import tempfile
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core import planner as PL
from repro_torch.core import sweep as SW
from repro_torch.core.spec import FULL_TRAIN

from .guard import Autopilot

#: the base cell starts at this fraction of the (normalized) budget, so
#: a drift ratio of 1 / BASE_FRAC = 1.25 is the OOM line
BASE_FRAC = 0.8

#: canonical harness cell: activation-heavy so every mitigation class
#: (grad-accum, offload, remat tightening) has real bytes to win back
HARNESS_ARCH = "smollm-360m"
HARNESS_MESH = (("data", 2), ("model", 2))
HARNESS_BATCH = 256
HARNESS_SEQ = 2048


def _ramp(start: float, stop: float, n: int) -> tuple:
    return tuple(round(start + (stop - start) * i / max(n - 1, 1), 4)
                 for i in range(n))


@dataclass(frozen=True)
class DriftScenario:
    """One synthetic trajectory of observed/predicted drift ratios."""

    name: str
    ratios: tuple                  # per-step drift ratio, len == n_steps
    description: str = ""

    @property
    def n_steps(self) -> int:
        return len(self.ratios)

    def crosses_budget(self) -> bool:
        return any(r > 1.0 / BASE_FRAC for r in self.ratios)


#: the scenario set every PR's OOM-avoidance rate is measured on; each
#: crosses the budget line (ratio 1.25) so the unguarded baseline aborts
SCENARIOS = (
    DriftScenario(
        "slow-leak",
        _ramp(0.90, 1.40, 20),
        "fragmentation-style creep: +2.6%/step across the budget line"),
    DriftScenario(
        "spike",
        (1.02, 1.04, 1.06, 1.06, 1.06, 1.06) + (1.30,) * 8,
        "steady mild drift, then a resident-buffer spike past budget"),
    DriftScenario(
        "underestimate",
        (1.30,) * 10,
        "the model underestimates from step 0 (unmodelled allocation)"),
)


def scenario(name: str) -> DriftScenario:
    for s in SCENARIOS:
        if s.name == name:
            return s
    raise KeyError(f"unknown scenario {name!r}; known: "
                   f"{[s.name for s in SCENARIOS]}")


@dataclass
class ScenarioResult:
    """Outcome of one trainer run under one scenario."""

    scenario: str
    guarded: bool
    completed: bool
    aborted: bool
    steps_done: int
    n_steps: int
    oom_steps: list
    mitigations: list              # applied action names, in order
    restarts: int
    budget_bytes: int
    base_predicted_bytes: int
    final_predicted_bytes: int

    @property
    def oom_free(self) -> bool:
        return not self.oom_steps

    def __str__(self) -> str:
        mode = "guarded" if self.guarded else "unguarded"
        out = ("completed" if self.completed else
               "ABORTED" if self.aborted else "stopped")
        mit = ",".join(self.mitigations) or "-"
        return (f"{self.scenario:<14} {mode:<9} {out:<9} "
                f"steps={self.steps_done}/{self.n_steps} "
                f"ooms={len(self.oom_steps)} mitigations=[{mit}] "
                f"restarts={self.restarts}")


def base_cell(chip: str = "v5e") -> SW.SweepCell:
    """The harness's starting knobs: loosest remat, no accumulation, no
    offload — every mitigation class still has room to act."""
    return SW.SweepCell(
        arch=HARNESS_ARCH, chip=chip, mesh=HARNESS_MESH,
        optimizer=None, remat="none", grad_accum=1,
        global_batch=HARNESS_BATCH, seq_len=HARNESS_SEQ,
        kind="train", backend="tpu")


def run_scenario(scn: DriftScenario, guarded: bool,
                 engine: Optional[SW.SweepEngine] = None,
                 chip: str = "v5e",
                 max_restarts: int = 3, compute_engine: str = "torch",
                 device: Optional[str] = None) -> ScenarioResult:
    """Drive ResilientTrainer through one scenario; returns the outcome.

    The budget is normalized so the base cell's raw prediction sits at
    ``BASE_FRAC`` of it (via the autopilot/planner ``headroom`` knob),
    making the drift trajectories arch-independent.  ``compute_engine``
    and ``device`` say where the guard's reshard search would run.
    """
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.runtime.fault_tolerance import (FaultConfig,
                                                     ResilientTrainer)

    engine = engine or SW.SweepEngine()
    cell = base_cell(chip)
    base_pred = engine.evaluate(cell, policy=FULL_TRAIN).peak_bytes
    budget = int(base_pred / BASE_FRAC)
    headroom = budget / PL.chip_hbm(chip)

    pilot = None
    if guarded:
        pilot = Autopilot(cell=cell, policy=FULL_TRAIN,
                          headroom=headroom, engine=engine,
                          compute_engine=compute_engine, device=device)

    def predicted_now() -> int:
        return pilot.watch.predicted_bytes if pilot is not None \
            else base_pred

    def usage(step: int) -> int:
        # true usage tracks the CURRENT cell's prediction
        return int(scn.ratios[min(step, scn.n_steps - 1)]
                   * predicted_now())

    oom_steps: list = []

    def injector(step: int) -> bool:
        if usage(step) > budget:
            oom_steps.append(step)
            return True
        return False

    done = {"n": 0}

    def train_step(state, batch):
        done["n"] += 1
        return state + 1, {"loss": 0.0}

    completed, aborted = False, False
    with tempfile.TemporaryDirectory(prefix="autopilot_harness_") as ckpt:
        trainer = ResilientTrainer(
            train_step=train_step,
            pipeline=None,
            checkpointer=Checkpointer(directory=ckpt),
            fault_cfg=FaultConfig(ckpt_every=10 ** 6,
                                  max_restarts=max_restarts),
            make_batch=lambda step: np.zeros(1),
            failure_injector=injector,
            autopilot=pilot, memory_source=usage)
        try:
            trainer.run(0, 0, scn.n_steps)
            completed = True
        except RuntimeError:
            aborted = True
    return ScenarioResult(
        scenario=scn.name, guarded=guarded, completed=completed,
        aborted=aborted, steps_done=done["n"], n_steps=scn.n_steps,
        oom_steps=oom_steps,
        mitigations=[m.action for m in pilot.applied] if pilot else [],
        restarts=trainer.restarts, budget_bytes=budget,
        base_predicted_bytes=base_pred,
        final_predicted_bytes=predicted_now())


def run_all(engine: Optional[SW.SweepEngine] = None,
            chip: str = "v5e", compute_engine: str = "torch",
            device: Optional[str] = None) -> list:
    """Every scenario, guarded AND unguarded; shared engine caches."""
    engine = engine or SW.SweepEngine()
    return [run_scenario(s, guarded, engine=engine, chip=chip,
                         compute_engine=compute_engine, device=device)
            for s in SCENARIOS for guarded in (True, False)]
