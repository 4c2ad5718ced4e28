"""One run of a training cell.

Set-up builds one object, the program's training step with its model and
optimizer state, on weights and a ring of ``RING`` batches drawn from the
seed, and drives it through the first ``STEPS_CHECKED`` steps with the
window's own call and feed, reading the program's side of the
comparison; one more step follows once the readings' buffers are freed.
Then the window: steps, each ended by a synchronize, until ``seconds``
have passed.  With ``trace``, ``TRACE_STEPS`` more steps run under the
profiler.  Then the program's state is freed and the reference follows
the same checked steps from the same weights and batches.
"""

from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace

import torch

from perfbench.harness import cell as CELL
from perfbench.harness import check, faults, inputs
from perfbench.harness import trace as TR
from perfbench.harness import weights as WT
from perfbench.harness.program import Program
from perfbench.reference import common as RC

RING = 4            # distinct batches, drawn in set-up; the steps cycle
STEPS_CHECKED = 2   # steps that the reference follows
TRACE_STEPS = 2     # steps under the profiler, well under its ~98,000
                    # kernels


class Cell:
    """A training cell's pieces on one device, from one seed."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        cfg = self.cfg = cell.config
        self.ref = CELL.plugin("reference", cfg["family"])
        self.lay = WT.layout(self.ref.weight_specs(cfg), cfg["torch_dtype"])
        pats = cfg["training"]["trainable"]
        self.trainable = {n for n in self.lay.names()
                          if any(p in n for p in pats)}
        self.ring = inputs.make_ring(seed, RING, cell.traffic, cfg,
                                     self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def batch(self, i: int) -> dict:
        return self.ring[i % len(self.ring)]

    def program(self, fault=None):
        """(the program on the drawn weights, their flat buffer)."""
        flat = WT.draw(self.seed, self.lay, self.device)
        prog = Program(self.cfg, CELL.plugin("program", self.cfg["family"]),
                       WT.views(flat, self.lay))
        if prog.trainable() != self.trainable:
            raise ValueError(
                f"the program trains {len(prog.trainable())} tensors, the "
                f"configuration {len(self.trainable)}")
        if fault:
            faults.plant(prog, fault)
        return prog, flat

    def checked_steps(self, prog) -> dict:
        """The checked steps, and the program's side of the comparison."""
        losses, grad1, change = [], None, None
        for s in range(STEPS_CHECKED):
            losses.append(float(prog.run(self.batch(s))))
            if s == 0:
                grad1 = prog.first_grad_norms(self.cfg["training"]["b1"])
            if s == STEPS_CHECKED - 1:
                start = WT.initial(self.seed, self.lay, self.trainable,
                                   self.device)
                change = prog.change_norms(start)
                del start
        return {"losses": losses, "grad1": grad1, "change": change}

    def reference(self, rnd=RC.identity) -> dict:
        """The reference's checked steps (``rnd``: its rounding, the
        identity but for the control)."""
        RC.exact()
        flat = WT.draw(self.seed, self.lay, self.device)
        out = RC.follow(
            lambda W, b, r: self.ref.loss_rows(self.cfg, W, b, r),
            WT.views(flat, self.lay), self.trainable,
            [self.batch(s) for s in range(STEPS_CHECKED)],
            self.cfg["training"], rnd)
        del flat
        free(self.device)
        return out


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        fault=None, log=None) -> dict:
    """One run of the cell; the result line's fields."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    since = lambda: f"{time.perf_counter() - t0:.3f} s"
    log(f"set-up: harness and program imported at {since()}")
    c = Cell(cell, seed, device)
    c.sync()
    log(f"set-up: batches (and the device's context) at {since()}")
    prog, flat = c.program(fault)
    c.sync()
    log(f"set-up: weights and the program's state at {since()}")
    got = c.checked_steps(prog)
    log(f"set-up: {STEPS_CHECKED} checked steps at {since()}")
    free(c.device)
    prog.run(c.batch(STEPS_CHECKED))
    c.sync()
    setup_s = time.perf_counter() - t0
    log(f"setup {setup_s:.3f} s; program's first losses {got['losses']}")

    cuda = c.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(c.device)
    losses, ends, i = [], [], STEPS_CHECKED + 1
    start = time.perf_counter()
    while True:
        losses.append(prog.run(c.batch(i)).detach())
        c.sync()
        i += 1
        ends.append(time.perf_counter())
        if ends[-1] - start >= seconds:
            break
    window = {"steps": len(losses), "seconds": ends[-1] - start}
    steps_s = sorted(b - a for a, b in zip([start] + ends, ends))
    log(f"window step times (s): min {steps_s[0]:.4f} median "
        f"{steps_s[len(steps_s) // 2]:.4f} max {steps_s[-1]:.4f}")
    peak_alloc = torch.cuda.max_memory_allocated(c.device) if cuda else 0
    peak_res = torch.cuda.max_memory_reserved(c.device) if cuda else 0
    failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
    log(f"window {window['steps']} steps in {window['seconds']:.3f} s, "
        f"peak {peak_alloc} B allocated, {peak_res} B reserved")

    tr = None
    if trace:
        step_no = [i]

        def one():
            prog.run(c.batch(step_no[0]))
            step_no[0] += 1
        tr = TR.traced(one, TRACE_STEPS, c.sync)
        if cuda and tr.busy_s <= 0:
            raise RuntimeError("the trace shows no device time")
        log(f"trace {tr.steps} steps: window {tr.window_s:.6f} s, busy "
            f"{tr.busy_s:.6f} s")
    del prog, flat, losses
    free(c.device)

    ref = c.reference()
    correct, checks = check.judge(check.gaps(got, ref), cell.limits)
    log(f"reference losses {ref['losses']}")
    work = CELL.plugin("flops", c.cfg["family"]).work(c.cfg, cell.traffic)
    ctx = SimpleNamespace(
        setup_s=setup_s, window=window, positions=inputs.positions_per_step(
            cell.traffic), peak_allocated=peak_alloc, peak_reserved=peak_res,
        trace=tr, work=work)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = CELL.plugin("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(c.device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak_alloc}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    result = {"correct": correct and failed == 0,
              "attempted": window["steps"], "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result
