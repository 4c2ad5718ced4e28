"""Where in a step the device's time goes: the program's spans (the
``repro_torch.*`` ranges of ``repro_torch.core.device_metrics.span``)
laid over the device operations of one step traced on the host and the
device, and the readings taken from them and from the program's
``SpanRecorder``.

A device operation is under a span when the host call that launched it
(the runtime call of the same correlation; else the host op the profiler
links it to) began within the span's host interval, on any thread.  Its
innermost span is, among those, the one that began last.  An idle gap of
the step (no device operation running) goes to the innermost span under
way at its middle, or to ``OUTSIDE``.  Times are microseconds on the
profiler's clock, seconds in the results.

With a program that opens no span every reading is None, never 0."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from perfbench.harness import peaks, work
from perfbench.harness.trace import STEP, _union

PREFIX = "repro_torch."
OUTSIDE = "(outside any program span)"

STATE = "repro_torch.train.state"
FORWARD = "repro_torch.train.forward"
BACKWARD = "repro_torch.train.backward"
OPTIMIZER = "repro_torch.train.optimizer"
RECOMPUTED = ("repro_torch.model.block", "repro_torch.model.loss_chunk")
FLASH = {"fwd": ("repro_torch.ops.flash_attention.fwd",),
         "bwd": ("repro_torch.ops.flash_attention.bwd",)}
RMSNORM = {"fwd": ("repro_torch.ops.rmsnorm.fwd",),
           "bwd": ("repro_torch.ops.rmsnorm.bwd",)}


@dataclass
class SpanTimes:
    steps: int
    window_s: float
    busy_s: float
    count: dict = field(default_factory=dict)      # name -> spans
    launches: dict = field(default_factory=dict)   # name -> ops under it
    device_s: dict = field(default_factory=dict)   # name -> s under it
    own_s: dict = field(default_factory=dict)      # innermost name -> s
    inside: dict = field(default_factory=dict)     # (inner, outer) -> s
    idle: dict = field(default_factory=dict)       # innermost name -> s
    unplaced: int = 0          # device ops whose launch was not found
    kernels: dict = field(default_factory=dict)    # op name -> [count, s]

    def kernel_time(self, names) -> tuple:
        """(spans, device seconds under them) of the spans named in
        ``names``: the shape ``work.roofline_share`` reads of a trace,
        a span standing for a launch and its ops for the kernel."""
        return (sum(self.count.get(n, 0) for n in names),
                sum(self.device_s.get(n, 0.0) for n in names))


def _innermost(starts, ends, names, t) -> str:
    inside = np.nonzero((starts <= t) & (t <= ends))[0]
    return names[inside[np.argmax(starts[inside])]] if len(inside) \
        else OUTSIDE


def attribute(spans: list, ops: list, window: tuple) -> SpanTimes:
    """``spans``: (start, end, name) host intervals; ``ops``: (start,
    end, launched) device intervals, ``launched`` the host time of the
    launch or None; ``window``: (start, end) of the traced step."""
    w0, w1 = window
    ss = np.asarray([s[0] for s in spans], dtype=np.float64)
    se = np.asarray([s[1] for s in spans], dtype=np.float64)
    names = [s[2] for s in spans]
    placed = [o for o in ops if o[2] is not None]
    t = np.asarray([o[2] for o in placed], dtype=np.float64)
    dur = np.asarray([o[1] - o[0] for o in placed], dtype=np.float64) * 1e-6
    under = (ss[None, :] <= t[:, None]) & (t[:, None] <= se[None, :])
    out = SpanTimes(steps=1, window_s=(w1 - w0) * 1e-6, busy_s=0.0,
                    unplaced=len(ops) - len(placed))
    cols: dict = {}
    for j, n in enumerate(names):
        cols.setdefault(n, []).append(j)
    for n, js in cols.items():
        hit = under[:, js].any(axis=1)
        out.count[n] = len(js)
        out.launches[n] = int(hit.sum())
        out.device_s[n] = float(dur[hit].sum())
    for i in range(len(t)):
        n = _innermost(ss, se, names, t[i])
        out.own_s[n] = out.own_s.get(n, 0.0) + float(dur[i])
    for inner, ji in cols.items():
        for outer, jo in cols.items():
            if inner == outer:
                continue
            lying = [j for j in ji if ((ss[jo] <= ss[j]) & (se[j] <= se[jo]))
                     .any()]
            if lying:
                out.inside[(inner, outer)] = float(
                    dur[under[:, lying].any(axis=1)].sum())
    iv = np.asarray([(max(a, w0), min(b, w1)) for a, b, _ in ops
                     if b > w0 and a < w1], dtype=np.float64).reshape(-1, 2)
    merged = _union(iv)
    out.busy_s = float((merged[:, 1] - merged[:, 0]).sum()) * 1e-6
    edges = np.concatenate([[w0], merged.reshape(-1), [w1]]).reshape(-1, 2)
    for a, b in edges:
        if b > a:
            n = _innermost(ss, se, names, 0.5 * (a + b))
            out.idle[n] = out.idle.get(n, 0.0) + float(b - a) * 1e-6
    return out


def from_events(events, step: str = STEP) -> SpanTimes:
    """The attribution of a profiler's events (``prof.events()`` of a
    trace of the host and the device, the step inside a ``step``
    range), with the device time and launches of each kernel.  A host
    range shows on the device's timeline too, under its own name: no
    such event is a device operation."""
    from torch.autograd import DeviceType
    host, device, launch, op_start = [], [], {}, {}
    for e in events:
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            device.append((a, b, e))
            continue
        host.append((a, b, e.name))
        if e.name.startswith("cu"):            # cudaLaunchKernel, ...
            launch[e.id] = a
        else:
            op_start.setdefault(e.id, a)
    windows = [(a, b) for a, b, n in host if n == step]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {step!r} "
                           f"ranges, not one")
    host_names = {n for _, _, n in host}
    ops, kernels = [], {}
    for a, b, e in device:
        if e.name in host_names or e.name.startswith(PREFIX):
            continue
        t = launch.get(e.id)
        if t is None:
            t = op_start.get(getattr(e, "linked_correlation_id", 0) or -1)
        ops.append((a, b, t))
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-6
    spans = [h for h in host if h[2].startswith(PREFIX)]
    out = attribute(spans, ops, windows[0])
    out.kernels = kernels
    return out


def profile_step(step_fn, sync) -> SpanTimes:
    """One step, ended by ``sync``, traced on the host and the device
    (the host alone without a card) and attributed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(STEP):
            step_fn()
            sync()
    return from_events(prof.events())


def _flash_op(c: dict, op: str, elt: int) -> tuple:
    """(operations, bytes) of one call of the attention op: the forward
    pass, or both backward passes added (each bound by its operations at
    the benchmark's shapes, so the bound of the sum is the sum of the
    bounds)."""
    if op == "fwd":
        return work.flash(c, "fwd", elt)
    (o1, b1), (o2, b2) = work.flash(c, "dq", elt), work.flash(c, "dkv", elt)
    return o1 + o2, b1 + b2


def _ms(times: SpanTimes, seconds):
    return None if seconds is None else 1e3 * seconds / times.steps


def readings(times, work_counts: dict, step_records=(),
             state_records=()) -> dict:
    """The per-layer readings of one traced step (``times``, None for
    none) and of the program's records (``SpanRecord`` s of that step
    and of the state's making), each None where nothing was found: the
    device's readings without a program span or a device operation, the
    allocator's off CUDA."""
    out = dict.fromkeys(("forward_ms", "backward_ms", "recompute_ms",
                         "optimizer_ms", "flash_op_roofline",
                         "rmsnorm_op_roofline", "saved_gib",
                         "state_init_s"))
    if times is not None and times.count and times.busy_s > 0:
        d = times.device_s
        out["forward_ms"] = _ms(times, d.get(FORWARD))
        out["backward_ms"] = _ms(times, d.get(BACKWARD))
        out["optimizer_ms"] = _ms(times, d.get(OPTIMIZER))
        parts = [times.inside[(n, BACKWARD)] for n in RECOMPUTED
                 if (n, BACKWARD) in times.inside]
        out["recompute_ms"] = _ms(times, sum(parts)) if parts else None
        elt = work_counts["elt_bytes"]
        out["flash_op_roofline"] = work.roofline_share(
            times, work_counts.get("attention"), FLASH, _flash_op, elt,
            peaks.BF16_FLOPS, peaks.HBM_BYTES)
        out["rmsnorm_op_roofline"] = work.roofline_share(
            times, work_counts.get("rmsnorm"), RMSNORM, work.rmsnorm, elt,
            peaks.FP32_FLOPS, peaks.HBM_BYTES)
    saved = [r.allocated_out - r.allocated_in for r in step_records
             if r.name == FORWARD and r.allocated_in is not None]
    if saved:
        out["saved_gib"] = max(saved) / 2 ** 30
    state = [r.seconds for r in state_records if r.name == STATE]
    if state:
        out["state_init_s"] = sum(state)
    return out
