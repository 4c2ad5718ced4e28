"""Where a cell's step spends the device's time and memory, by the
program's spans, at the cell's own size on the card, in one process:

    python3 perfbench/breakdown.py --workload <name> --seed <n> \
        [--out FILE]

The program is built as a benchmark run builds it, its state's making
under a ``SpanRecorder``; ``WARM`` steps follow, then ``TIMED`` steps
each ended by a synchronize, one step traced on the device alone (as the
benchmark's traced window is) and one traced on the host and the device
under a second recorder.  One JSON line: the readings of
``harness/spans.py`` and, from the same step, the benchmark's rooflines
of the flash and RMSNorm kernels by name; each span's count, launches
and device seconds, the device seconds by innermost span and inside
other spans, the idle seconds by span, the host-traced step's window and
busy time, the phase records, the untraced steps' host seconds and the
names of the device-only trace's events that are program spans.  A
program that opens no span (and has no recorder) gives the times and
None for every reading.  The benchmark's own runs do not run this."""

import contextlib
import json
import sys
import time
from dataclasses import asdict
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import perfbench.run  # noqa: E402,F401  (the runs' caches and paths)

WARM = 3     # steps before any timing: the first builds and warms
TIMED = 3    # untraced steps, each timed on the host's clock


def breakdown(cell, seed: int, device, log=print) -> dict:
    from repro_torch.core import device_metrics as DM
    from perfbench.harness import cell as CELL
    from perfbench.harness import spans, train
    from perfbench.harness import trace as TR
    c = train.Cell(cell, seed, device)
    recorder = getattr(DM, "SpanRecorder", None)

    def recording():
        return recorder(c.device) if recorder else \
            contextlib.nullcontext()
    with recording() as state_rec:
        prog, flat = c.program()
    c.sync()
    for i in range(WARM):
        prog.run(c.batch(i))
    c.sync()
    step_s = []
    for i in range(WARM, WARM + TIMED):
        t = time.perf_counter()
        prog.run(c.batch(i))
        c.sync()
        step_s.append(time.perf_counter() - t)
    n = [WARM + TIMED]

    def one():
        prog.run(c.batch(n[0]))
        n[0] += 1
    dev_only = TR.traced(one, 1, c.sync)
    with recording() as step_rec:
        t = time.perf_counter()
        times = spans.profile_step(one, c.sync)
        traced_s = time.perf_counter() - t
    work = CELL.plugin("flops", c.cfg["family"]).work(c.cfg, cell.traffic)
    same_step = SimpleNamespace(work=work, trace=TR.Trace(
        steps=1, window_s=times.window_s, busy_s=times.busy_s,
        kernels=times.kernels))

    def records(rec):
        return [] if rec is None else rec.records
    out = {
        "workload": cell.name, "seed": seed,
        "readings": spans.readings(times, work, records(step_rec),
                                   records(state_rec)),
        "kernel_rooflines": {
            m: CELL.plugin("metrics", m).read(same_step)
            for m in ("flash_roofline", "rmsnorm_roofline")},
        "untraced_step_s": step_s, "host_traced_step_s": traced_s,
        "window_s": times.window_s, "busy_s": times.busy_s,
        "unplaced_ops": times.unplaced,
        "device_s": times.device_s, "launches": times.launches,
        "count": times.count, "own_s": times.own_s,
        "inside_s": {f"{a} in {b}": s for (a, b), s in times.inside.items()},
        "idle_by_span": times.idle,
        "phase_records": [asdict(r) for r in records(step_rec)
                          + records(state_rec)],
        "device_only": {"busy_s": dev_only.busy_s,
                        "window_s": dev_only.window_s,
                        "span_events": sorted(
                            k for k in dev_only.kernels
                            if k.startswith(spans.PREFIX))},
    }
    del prog, flat
    train.free(c.device)
    log(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from perfbench.harness import cell as CELL
    out = breakdown(CELL.load(args.workload), args.seed, "cuda")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
