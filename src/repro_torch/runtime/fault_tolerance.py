"""Fault-tolerant training loop: checkpoint/restart, failure recovery,
straggler mitigation, elastic rescaling — the reference's
``repro/runtime/fault_tolerance.py``, driving the port's train step.

On a real cluster the failure signal comes from the coordination service
(heartbeat loss); here the loop exposes the same control flow with an
injectable failure source so the logic is testable:

* every ``ckpt_every`` steps the state is checkpointed asynchronously (a
  host copy is taken before the step after it updates the state in
  place);
* a step failure (device loss / preemption) triggers restore-from-latest
  and replay — the batches are a function of the step
  (``make_batch(step)``), so the replay sees the same ones;
* per-step wall times feed an EWMA straggler detector; a flagged shard's
  data range is reassigned to healthy hosts (deterministic re-partition);
* ``rescale(new_n_shards)`` re-partitions the data for a new host count.

The pipeline is ``repro_torch.data.SyntheticPipeline`` (or any object
with ``n_shards`` / ``shard_id`` / ``global_batch(step)``), driven as the
reference drives its own: batches come from ``global_batch(step)``
unless ``make_batch`` is given (the launcher's moves the pipeline's numpy
batch onto the device), a straggler rotates ``shard_id`` and ``rescale``
sets ``n_shards``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.checkpoint import Checkpointer


@dataclass
class FaultConfig:
    ckpt_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 2.0    # step slower than factor*EWMA => flag
    ewma_alpha: float = 0.2


@dataclass
class ResilientTrainer:
    """Drives ``train_step`` with checkpoint/restart semantics."""

    train_step: Callable              # (state, batch) -> (state, metrics)
    pipeline: Any                     # data pipeline (shard_batch/global_batch)
    checkpointer: Checkpointer
    fault_cfg: FaultConfig = field(default_factory=FaultConfig)
    make_batch: Optional[Callable] = None   # step -> batch (overrides pipeline)
    failure_injector: Optional[Callable] = None  # step -> bool (tests)
    on_straggler: Optional[Callable] = None
    # memory autopilot hook (repro_torch.autopilot.Autopilot) + its
    # telemetry source (step -> observed bytes / dryrun record / None).
    # When both are set, every step is admission-controlled: the autopilot
    # observes BEFORE the step runs so a mitigation lands ahead of the
    # allocation that would have OOMed, and every restart re-validates the
    # mesh through planner.check_parallel via on_restart.
    autopilot: Optional[Any] = None
    memory_source: Optional[Callable] = None

    _ewma: Optional[float] = None
    restarts: int = 0                       # lifetime stat (never resets)
    _consecutive_failures: int = 0          # the abort budget
    straggler_events: list = field(default_factory=list)

    def _batch(self, step: int):
        if self.make_batch is not None:
            return self.make_batch(step)
        return self.pipeline.global_batch(step)

    def run(self, state, start_step: int, n_steps: int,
            log_every: int = 0) -> tuple[Any, list]:
        history = []
        step = start_step
        while step < start_step + n_steps:
            if self.autopilot is not None and self.memory_source is not None:
                # admission control: classify the upcoming step's memory
                # before launching it, so a mitigation beats the OOM
                self.autopilot.observe(step, self.memory_source(step))
            batch = self._batch(step)
            t0 = time.monotonic()
            try:
                if self.failure_injector and self.failure_injector(step):
                    raise RuntimeError(f"injected failure at step {step}")
                state, metrics = self.train_step(state, batch)
            except Exception:
                # `restarts` is the lifetime stat; the abort decision
                # rides the CONSECUTIVE counter (reset on success), so a
                # long run with occasional recovered failures is never
                # killed by its uptime.
                self.restarts += 1
                self._consecutive_failures += 1
                if self._consecutive_failures > self.fault_cfg.max_restarts:
                    raise
                restored_step, restored = self.checkpointer.restore_latest(
                    like=state)
                if restored is not None:
                    state = restored
                    step = int(restored_step)
                # else: replay from start_step state (no ckpt yet)
                if self.autopilot is not None:
                    self.autopilot.on_restart(step)
                continue
            self._consecutive_failures = 0
            dt = time.monotonic() - t0
            self._track_stragglers(step, dt)
            history.append({"step": step, **{k: float(v)
                                             for k, v in metrics.items()}})
            step += 1
            if step % self.fault_cfg.ckpt_every == 0:
                self.checkpointer.save_async(step, state)
            if log_every and step % log_every == 0:
                print(f"step {step}: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in history[-1].items()
                    if k != "step"))
        self.checkpointer.save_async(step, state)
        self.checkpointer.wait()
        return state, history

    def _track_stragglers(self, step: int, dt: float) -> None:
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.fault_cfg.straggler_factor * self._ewma:
            self.straggler_events.append((step, dt, self._ewma))
            if self.on_straggler:
                self.on_straggler(step, dt)
            # Mitigation: deterministic pipeline lets healthy hosts take
            # over the slow shard's row range next step — rotate onto
            # the NEXT shard, which is always a different, valid id.
            if hasattr(self.pipeline, "n_shards") \
                    and self.pipeline.n_shards > 1:
                self.pipeline.shard_id = ((self.pipeline.shard_id + 1)
                                          % self.pipeline.n_shards)
        a = self.fault_cfg.ewma_alpha
        self._ewma = (1 - a) * self._ewma + a * dt

    # -- elastic scaling ----------------------------------------------------
    def rescale(self, new_n_shards: int) -> None:
        """Re-partition the data pipeline for a new host count.  With an
        autopilot attached the elastic resize re-validates the mesh
        (planner.check_parallel) before the run resumes."""
        self.pipeline.n_shards = new_n_shards
        self.pipeline.shard_id = min(self.pipeline.shard_id,
                                     new_n_shards - 1)
        if self.autopilot is not None:
            self.autopilot.on_restart(-1)
