"""The readings that a cell's limits are set from, at the cell's own size
on the card, in one process:

    python3 perfbench/control.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--faults half_batch,loss_altered] \
        [--fault-seeds 1,2,3] [--out FILE]

For each seed: the program's checked steps and the reference's, and the
gaps between them (the lower readings); on the fault seeds the same with
each fault planted under the program's step; on the control seeds the
control (the reference computed with every product's operands rounded to
float8 e4m3, the precision below the configuration's bfloat16) in the
program's place (the upper readings).  One JSON line per seed, with each
side's norms leaf by leaf, and all of them in ``--out``.  The benchmark's
own runs do not run this."""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import perfbench.run  # noqa: E402,F401  (the runs' caches and paths)


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def readings(cell, seed: int, device, faults=(), control=False,
             log=print) -> dict:
    """The gaps of the sound program, of each fault and of the control
    from the reference on one seed."""
    from perfbench.harness import train
    from perfbench.harness import check
    from perfbench.reference import common as RC
    c = train.Cell(cell, seed, device)
    out = {"seed": seed}
    runs = {}
    for fault in (None, *faults):
        t = time.perf_counter()
        prog, flat = c.program(fault)
        runs[fault or "program"] = c.checked_steps(prog)
        del prog, flat
        train.free(device)
        out[f"{fault or 'program'}_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ref = c.reference()
    out["reference_s"] = time.perf_counter() - t
    if control:
        t = time.perf_counter()
        runs["control"] = c.reference(RC.round_fp8)
        out["control_s"] = time.perf_counter() - t
    for name, got in (*runs.items(), ("reference", ref)):
        if name != "reference":
            out[name] = check.gaps(got, ref)
        out[name + "_losses"] = got["losses"]
        out[name + "_leaves"] = {"grad1": got["grad1"],
                                 "change": got["change"]}
    log(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from perfbench.harness import cell as CELL
    cell = CELL.load(args.workload)
    faults = [f for f in args.faults.split(",") if f]
    rows = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds
                              + args.fault_seeds):
        rows.append(readings(
            cell, seed, "cuda",
            faults if seed in args.fault_seeds else (),
            seed in args.control_seeds))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
