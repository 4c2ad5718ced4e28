"""Memory-autopilot CLI.

    python -m repro_torch.autopilot                       # all scenarios, both modes
    python -m repro_torch.autopilot --scenario slow-leak  # one scenario
    python -m repro_torch.autopilot --unguarded-only      # the failing baseline
    python -m repro_torch.autopilot --list                # scenario catalogue
    python -m repro_torch.autopilot --ingest experiments/measured  # artifact triage
    python -m repro_torch.autopilot --device cpu          # on a host without a card

Exit status is nonzero when any GUARDED run aborts or suffers an
injected OOM — the property CI pins.  The output and exit status are the
reference's (its ``repro.autopilot`` CLI).  The guard's reshard search
runs on the torch engine on the card unless ``--engine numpy`` or
``--device cpu`` asks for the host; with no card present the default
exits 2 before any scenario runs.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core.sweep import SweepEngine

from .harness import SCENARIOS, run_scenario, scenario
from .watch import scan_dryrun_dir

GiB = 1024 ** 3


def _print_result(r) -> None:
    print(f"  {r}")
    if r.guarded and r.mitigations:
        print(f"    predicted {r.base_predicted_bytes / GiB:.2f} -> "
              f"{r.final_predicted_bytes / GiB:.2f} GiB "
              f"(budget {r.budget_bytes / GiB:.2f})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.autopilot",
        description="closed-loop OOM avoidance: scenarios + telemetry "
                    "triage")
    ap.add_argument("--scenario", help="run one named scenario")
    ap.add_argument("--list", action="store_true",
                    help="list scenarios and exit")
    ap.add_argument("--guarded-only", action="store_true")
    ap.add_argument("--unguarded-only", action="store_true")
    ap.add_argument("--chip", default="v5e")
    ap.add_argument("--ingest", metavar="DIR",
                    help="triage dryrun artifacts in DIR (telemetry "
                         "ingest only; no scenarios)")
    ap.add_argument("--engine", choices=("torch", "numpy"), default="torch",
                    help="where the guard's reshard search sweeps: torch "
                         "(default) or the host columnar path (numpy); "
                         "the same answers")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="device of the torch engine (default cuda; exits "
                         "2 when no CUDA device is present)")
    args = ap.parse_args(argv)

    if args.list:
        for s in SCENARIOS:
            print(f"{s.name:<14} {s.n_steps:>3} steps  peak ratio "
                  f"{max(s.ratios):.2f}  {s.description}")
        return 0

    if args.ingest:
        rows = scan_dryrun_dir(args.ingest)
        if not rows:
            print(f"no artifacts under {args.ingest}")
            return 1
        bad = 0
        for name, obs in rows:
            if obs is None:
                bad += 1
                print(f"  {name:<60} telemetry unavailable")
            else:
                print(f"  {name:<60} {obs / GiB:8.2f} GiB")
        print(f"{len(rows)} artifacts, {bad} unusable")
        return 0

    try:
        todo = [scenario(args.scenario)] if args.scenario \
            else list(SCENARIOS)
    except KeyError as e:
        ap.error(str(e))
    if args.engine == "torch" and (args.device or "cuda") == "cuda":
        import torch
        if not torch.cuda.is_available():
            ap.error("--engine torch runs on a CUDA device and none is "
                     "present; pass --device cpu to run on the host")
    modes = [True, False]
    if args.guarded_only:
        modes = [True]
    if args.unguarded_only:
        modes = [False]

    engine = SweepEngine()
    failures = 0
    for s in todo:
        print(f"scenario {s.name}: {s.description}")
        for guarded in modes:
            r = run_scenario(s, guarded, engine=engine, chip=args.chip,
                             compute_engine=args.engine, device=args.device)
            _print_result(r)
            if guarded and (r.aborted or r.oom_steps):
                failures += 1
    if failures:
        print(f"{failures} guarded run(s) aborted or OOMed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
