"""Ranked mitigation planning: knob moves that buy back memory headroom.

On a DRIFT/CRITICAL verdict the planner enumerates candidate cell
mutations, predicts each through the memoized
:class:`~repro_torch.core.sweep.SweepEngine` (component groups shared with
every other prediction this process made), and ranks them by

    (reaches safety, estimated throughput cost, -headroom gained)

so the cheapest knob that actually clears the projected peak wins.
Candidates, cheapest first by prior:

* ``microbatches``  — double the microbatch count (pp > 1 only: shrinks
  the 1F1B stash); near-free, it only re-slices the schedule.
* ``grad_accum``    — double gradient accumulation: halves the
  micro-batch activations at some step-efficiency cost.
* ``offload_opt``   — host-offload the optimizer states, keeping only
  the Eq.1 double-buffered staging window on device; costs PCIe/ICI
  streaming bandwidth each update.
* ``remat``         — tighten the rematerialization policy one notch
  (none -> dots -> block); costs recompute FLOPs in the backward.
* ``reshard``       — :func:`repro_torch.core.planner.plan_min_chips` over
  larger chip counts: the last resort, it needs new hardware.  Its
  sliced sweeps run on the torch engine on the card
  (``compute_engine="torch"``, ``device`` None = ``"cuda"``) unless the
  caller asks for the host (``compute_engine="numpy"`` or
  ``device="cpu"``), as the planner's other queries do; the answer is
  the same either way.

Predicted savings are Eq.1 arithmetic, so every candidate's
``predicted_bytes`` is exactly what ``planner.check`` would report for
the mutated cell — the guard re-validates that equality before applying
a plan.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from repro_torch.configs import ShapeConfig
from repro_torch.core import planner as PL
from repro_torch.core import sweep as SW
from repro_torch.core.spec import FULL_TRAIN

#: remat ladder, loosest to tightest (factors.eff_act_saved semantics:
#: "none" saves everything, "dots" drops matmul partials, "block" keeps
#: only the scan carry)
REMAT_LADDER = ("none", "dots", "block")

#: static throughput-cost priors (fraction of step time sacrificed);
#: ranking inputs, not measurements — they order candidates, nothing else
COST_PRIOR = {
    "microbatches": 0.02,
    "grad_accum": 0.10,
    "offload_opt": 0.15,
    "remat": 0.30,
    "reshard": 1.00,
}


@dataclass(frozen=True)
class Mitigation:
    """One candidate knob move and its predicted effect."""

    action: str                    # COST_PRIOR key
    cell: SW.SweepCell             # the mutated cell
    predicted_bytes: int           # Eq.1 peak of the mutated cell
    projected_bytes: int           # drift-scaled peak (ewma * predicted)
    budget_bytes: int
    throughput_cost: float
    note: str = ""

    @property
    def safe(self) -> bool:
        return self.projected_bytes <= self.budget_bytes

    @property
    def headroom_gained(self) -> int:
        return self.budget_bytes - self.projected_bytes

    def __str__(self) -> str:
        gib = 1024 ** 3
        verdict = "safe" if self.safe else "STILL OVER"
        return (f"{self.action:<12} -> {self.predicted_bytes / gib:.2f} "
                f"GiB predicted ({self.projected_bytes / gib:.2f} "
                f"projected vs {self.budget_bytes / gib:.2f} budget, "
                f"{verdict}; cost~{self.throughput_cost:.2f}) {self.note}")


@dataclass(frozen=True)
class MitigationPlan:
    """Ranked candidates for one drifting cell."""

    cell: SW.SweepCell
    projected_bytes: int
    budget_bytes: int
    ewma_ratio: float
    candidates: tuple              # of Mitigation, ranked best-first

    @property
    def best(self) -> Optional[Mitigation]:
        return self.candidates[0] if self.candidates else None

    @property
    def reaches_safety(self) -> bool:
        return bool(self.candidates) and self.candidates[0].safe


@dataclass
class MitigationPlanner:
    """Enumerate + rank mitigations through a shared SweepEngine."""

    engine: SW.SweepEngine = field(default_factory=SW.SweepEngine)
    policy: object = FULL_TRAIN
    headroom: float = PL.HEADROOM
    profile: object = None
    # learned ResidualModel applied on top of the profile; the guard
    # updates this in place after a continual refit so candidate ranking
    # and the _apply byte-equality validation see the same corrections
    residual: object = None
    reshard_chips: tuple = (8, 16, 32, 64)
    # re-pricing path knobs: the reshard search prunes through
    # core.search by default ("exhaustive" restores brute-force
    # enumeration — answers are identical either way), and its sweep
    # slices run on compute_engine ("torch", on ``device``: the card when
    # None; "numpy": the host columnar path)
    search: str = "pruned"
    compute_engine: str = "torch"
    device: Optional[str] = None

    def _predict(self, cell: SW.SweepCell) -> int:
        res = self.engine.evaluate(cell, policy=self.policy,
                                   headroom=self.headroom,
                                   profile=self.profile,
                                   residual=self.residual)
        return res.peak_bytes

    # -- candidate enumeration ----------------------------------------------
    def _mutations(self, cell: SW.SweepCell):
        """(action, mutated_cell, note) tuples; mutations that don't
        apply to this cell (already at the knob's limit, wrong kind)
        are skipped rather than emitted as no-ops."""
        cfg, _, _ = self.engine._arch_state(cell.arch, self.policy)
        out = []
        pp = dict(cell.mesh).get("pipe", 1)
        if pp > 1 and cell.kind == "train":
            m = max(cell.microbatches, 1) * 2
            gb_micro = max(cell.global_batch // max(cell.grad_accum, 1), 1)
            if m <= gb_micro and gb_micro % m == 0:
                out.append(("microbatches",
                            replace(cell, microbatches=m),
                            f"microbatches {cell.microbatches} -> {m}"))
        if cell.kind == "train":
            a = max(cell.grad_accum, 1) * 2
            if a <= cell.global_batch and cell.global_batch % a == 0:
                out.append(("grad_accum", replace(cell, grad_accum=a),
                            f"grad_accum {cell.grad_accum} -> {a}"))
            if not cell.offload:
                out.append(("offload_opt", replace(cell, offload=True),
                            "optimizer states -> host tier"))
            cur = cell.remat or cfg.remat
            if cur in REMAT_LADDER:
                for nxt in REMAT_LADDER[REMAT_LADDER.index(cur) + 1:]:
                    out.append(("remat", replace(cell, remat=nxt),
                                f"remat {cur} -> {nxt}"))
        return out

    def _reshard(self, cell: SW.SweepCell,
                 ewma_ratio: float) -> Optional[Mitigation]:
        """plan_min_chips over chip counts above the current mesh; the
        enumerated factorizations check_parallel would reject are
        filtered inside the search."""
        n_now = cell.n_chips
        chips = tuple(c for c in self.reshard_chips if c > n_now)
        if not chips or cell.kind != "train":
            return None
        shape = ShapeConfig("autopilot", cell.seq_len, cell.global_batch,
                            cell.kind)
        res = PL.plan_min_chips(
            cell.arch, shape, chips=chips, chip=cell.chip,
            policy=self.policy, backend=cell.backend,
            headroom=self.headroom, profile=self.profile,
            engine=self.engine, search=self.search,
            compute_engine=self.compute_engine, device=self.device)
        if res is None:
            return None
        new = SW.SweepCell(
            arch=cell.arch, chip=cell.chip,
            mesh=tuple(sorted(res.mesh_shape.items())),
            optimizer=cell.optimizer, remat=res.remat,
            grad_accum=res.grad_accum, global_batch=cell.global_batch,
            seq_len=cell.seq_len, kind=cell.kind, backend=cell.backend,
            schedule=res.schedule, microbatches=res.microbatches,
            offload=cell.offload)
        pred = self._predict(new)
        budget = int(PL.chip_hbm(cell.chip) * self.headroom)
        cost = COST_PRIOR["reshard"] * res.n_chips / max(n_now, 1)
        return Mitigation(
            action="reshard", cell=new, predicted_bytes=pred,
            projected_bytes=int(ewma_ratio * pred), budget_bytes=budget,
            throughput_cost=cost,
            note=f"{n_now} -> {res.n_chips} chips ({res.mesh_str})")

    # -- ranking -------------------------------------------------------------
    def plan(self, cell: SW.SweepCell, ewma_ratio: float = 1.0,
             allow_reshard: bool = True) -> MitigationPlan:
        """Rank every applicable mitigation for ``cell`` under the
        watch's drift ratio.  A candidate is "safe" when its
        drift-scaled projection clears the chip budget."""
        ratio = max(float(ewma_ratio), 1.0)
        budget = int(PL.chip_hbm(cell.chip) * self.headroom)
        base_pred = self._predict(cell)
        cands = []
        for action, mutated, note in self._mutations(cell):
            pred = self._predict(mutated)
            if pred >= base_pred:
                continue               # no savings: not a mitigation
            cands.append(Mitigation(
                action=action, cell=mutated, predicted_bytes=pred,
                projected_bytes=int(ratio * pred), budget_bytes=budget,
                throughput_cost=COST_PRIOR[action], note=note))
        if allow_reshard and not any(c.safe for c in cands):
            rs = self._reshard(cell, ratio)
            if rs is not None:
                cands.append(rs)
        cands.sort(key=lambda c: (not c.safe, c.throughput_cost,
                                  -c.headroom_gained))
        return MitigationPlan(cell=cell,
                              projected_bytes=int(ratio * base_pred),
                              budget_bytes=budget, ewma_ratio=ratio,
                              candidates=tuple(cands))
