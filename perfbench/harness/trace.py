"""A few steps under ``torch.profiler`` and what the benchmark reads from
the trace: the traced window (the host's clock around the steps, each
ending in a synchronize, traced on the device alone), the time in which
some operation ran on the device in it (the union of the device events'
intervals), the device time and launches of each kernel; and from one
more step traced on the host as well, its idle gaps, each named by what
the host was doing in its middle (the host event that began last of
those under way there).

Keep a traced window well under ~98,000 kernels: past that the profiler
has been seen to lose the device's events."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.autograd import DeviceType

STEP = "perfbench.step"
# the longest gaps are named one by one; the rest are summed
LABELLED = 2000


@dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)   # name -> [count, s]
    gaps: dict = field(default_factory=dict)      # host event -> s

    def kernel_time(self, patterns) -> tuple:
        """(launches, device seconds) of the kernels whose name holds
        any of ``patterns``."""
        n, s = 0, 0.0
        for name, (count, sec) in self.kernels.items():
            if any(p in name for p in patterns):
                n, s = n + count, s + sec
        return n, s

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], v[1]] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in gaps]}


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged, sorted [start, end) rows of ``intervals``."""
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out)


def _device_events(prof, names_on_host) -> list:
    """(start, end, name) in microseconds of the operations that ran on
    the device.  A span opened on the host (record_function) shows on the
    device's timeline too, under the same name: it is no operation."""
    return [(float(e.time_range.start), float(e.time_range.end), e.name)
            for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name not in names_on_host]


def traced(step_fn, n_steps: int, sync) -> Trace:
    """Run ``step_fn`` ``n_steps`` times under the profiler tracing the
    device alone (the host's own events would slow the host), each step
    ended by ``sync``: the window is the host's clock around the steps,
    and every device event in the trace is theirs.  Then one more step
    under a trace of the host too, whose idle gaps are named by what the
    host was doing."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CUDA] if cuda else
                 [ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step_fn()
            sync()
        window_us = (time.perf_counter() - t0) * 1e6
    dev = _device_events(prof, ()) if cuda else []
    kernels: dict = {}
    for a, b, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-6
    merged = _union(np.asarray([(a, b) for a, b, _ in dev],
                               dtype=np.float64).reshape(-1, 2))
    busy_us = float((merged[:, 1] - merged[:, 0]).sum()) if len(merged) \
        else 0.0
    return Trace(steps=n_steps, window_s=window_us * 1e-6,
                 busy_s=busy_us * 1e-6, kernels=kernels,
                 gaps=_named_gaps(step_fn, sync))


def _named_gaps(step_fn, sync) -> dict:
    """One step traced on the host and the device: {what the host was
    doing: seconds of the step's idle gaps}."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(STEP):
            step_fn()
            sync()
    host, spans = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            continue
        a, b = float(e.time_range.start), float(e.time_range.end)
        (spans if e.name == STEP else host).append((a, b, e.name))
    if not spans:
        raise RuntimeError("the trace holds no step span")
    w0, w1 = spans[0][0], spans[0][1]
    dev = _device_events(prof, {STEP} | {h[2] for h in host})
    iv = np.asarray([(max(a, w0), min(b, w1)) for a, b, _ in dev
                     if b > w0 and a < w1], dtype=np.float64).reshape(-1, 2)
    edges = np.concatenate([[w0], _union(iv).reshape(-1), [w1]]) \
        .reshape(-1, 2)
    gaps: dict = {}
    lengths = edges[:, 1] - edges[:, 0]
    order = np.argsort(-lengths)
    order = order[lengths[order] > 0]
    if len(order) > LABELLED:
        gaps["(shorter gaps)"] = float(lengths[order[LABELLED:]].sum()) * 1e-6
        order = order[:LABELLED]
    hs = np.asarray([h[0] for h in host], dtype=np.float64)
    he = np.asarray([h[1] for h in host], dtype=np.float64)
    for i in order:
        mid = 0.5 * (edges[i, 0] + edges[i, 1])
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        name = host[inside[np.argmax(hs[inside])]][2] if len(inside) \
            else "(host outside any profiled op)"
        gaps[name] = gaps.get(name, 0.0) + float(lengths[i]) * 1e-6
    return gaps
