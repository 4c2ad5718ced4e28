"""Ground truth from the CUDA caching allocator around one real step.

The counterpart of the reference's ``core/xla_metrics.py``
``MemoryStats`` / ``memory_stats`` (``compiled.memory_analysis()`` of a
dry-run compile): the same four counters and ``total_bytes``, here read
from ``torch.cuda``'s allocator around one step on the card:

* ``baseline`` = ``memory_allocated()`` before the cell's parameters exist;
* ``start``    = allocated at the start of the step (parameters, optimizer
  state, inputs, cache: the step's arguments);
* ``end``      = allocated after it, following ``synchronize()``;
* ``peak``     = ``max_memory_allocated()`` after ``reset_peak_memory_stats()``
  at the start;

and ``argument = start - baseline``, ``output = end - baseline``, ``alias =
min(start, end) - baseline`` (what the step's outputs share with its
arguments: updated in place, or kept alive), ``temp = peak - baseline -
argument - output + alias``, so that ``total_bytes = peak - baseline``
exactly.

This module reads the allocator only: on a device that is not CUDA it
raises, and it never reports a zero for a step it did not see.  The
reference's HLO-text parsers (``shape_bytes``, ``collective_stats``,
``cost_stats``, ``loop_aware_stats``) read a compiled XLA program, which
PyTorch does not produce; their counterparts are ROADMAP A5b.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass
class MemoryStats:
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int

    @property
    def total_bytes(self) -> int:
        return (self.argument_bytes + self.temp_bytes
                + self.output_bytes - self.alias_bytes)


@dataclass
class StepMemory:
    """One step's allocator readings: the four counters and what they are
    built from, plus the caching allocator's own view (reserved bytes,
    retries after a failed ``cudaMalloc``)."""

    stats: MemoryStats
    baseline_bytes: int
    start_bytes: int
    end_bytes: int
    peak_bytes: int
    max_reserved_bytes: int
    alloc_retries: int

    @property
    def reserved_over_allocated(self) -> float:
        return self.max_reserved_bytes / self.peak_bytes


def _cuda(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"device_metrics reads the CUDA caching allocator; "
                         f"{dev} is not a CUDA device")
    if not torch.cuda.is_available():
        raise RuntimeError("device_metrics: no CUDA device is available")
    return dev


def allocated_bytes(device="cuda") -> int:
    """``memory_allocated()`` after the device's queued work is done."""
    dev = _cuda(device)
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev)


def memory_stats(step: Callable[[], Any], baseline: int,
                 device="cuda") -> tuple[StepMemory, Any]:
    """Run ``step()`` once on ``device`` between two allocator readings;
    ``baseline`` is :func:`allocated_bytes` from before the cell's
    parameters were made.  Returns the readings and what ``step``
    returned (kept alive, so ``end`` counts the step's outputs)."""
    dev = _cuda(device)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
    start = torch.cuda.memory_allocated(dev)
    out = step()
    torch.cuda.synchronize(dev)
    end = torch.cuda.memory_allocated(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    reserved = torch.cuda.max_memory_reserved(dev)
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries",
                                               0) - retries
    if not baseline <= min(start, end) <= peak:
        raise RuntimeError(f"allocator readings out of order: baseline "
                           f"{baseline}, start {start}, end {end}, peak "
                           f"{peak}")
    argument, output = start - baseline, end - baseline
    alias = min(start, end) - baseline
    stats = MemoryStats(argument_bytes=argument, output_bytes=output,
                        temp_bytes=peak - baseline - argument - output
                        + alias, alias_bytes=alias)
    if stats.temp_bytes < 0 or stats.total_bytes != peak - baseline:
        raise RuntimeError(f"allocator counters inconsistent: {stats}")
    return StepMemory(stats=stats, baseline_bytes=baseline,
                      start_bytes=start, end_bytes=end, peak_bytes=peak,
                      max_reserved_bytes=reserved,
                      alloc_retries=retries), out
