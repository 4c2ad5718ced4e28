"""Memory autopilot: closed-loop OOM avoidance.

Telemetry ingest (:mod:`.watch`) classifies live allocator stats
against the calibrated Eq.1 prediction; the mitigation planner
(:mod:`.mitigation`) ranks knob moves by predicted headroom vs
throughput cost; the guard (:mod:`.guard`) validates and applies them
and hooks into the fault-tolerant trainer; the harness
(:mod:`.harness`) replays synthetic OOM trajectories to prove the loop
closes.  ``python -m repro_torch.autopilot`` drives it all from the CLI.

The port of the reference's autopilot: every verdict, plan and scenario
outcome equals the reference's.  Predictions go through the port's
memoized sweep engine and planner; the one search on the card is the
planner's reshard (``planner.plan_min_chips`` on the torch engine).
"""

from .guard import Autopilot, MitigationError
from .harness import (DriftScenario, SCENARIOS, ScenarioResult, base_cell,
                      run_all, run_scenario, scenario)
from .mitigation import (COST_PRIOR, Mitigation, MitigationPlan,
                         MitigationPlanner, REMAT_LADDER)
from .watch import (MemoryWatch, WatchSample, WatchState, load_dryrun,
                    observed_bytes, scan_dryrun_dir)

__all__ = [
    "Autopilot", "MitigationError",
    "DriftScenario", "SCENARIOS", "ScenarioResult", "base_cell",
    "run_all", "run_scenario", "scenario",
    "COST_PRIOR", "Mitigation", "MitigationPlan", "MitigationPlanner",
    "REMAT_LADDER",
    "MemoryWatch", "WatchSample", "WatchState", "load_dryrun",
    "observed_bytes", "scan_dryrun_dir",
]
