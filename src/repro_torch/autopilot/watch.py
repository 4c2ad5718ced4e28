"""Telemetry ingest + drift classification for the memory autopilot.

The watch consumes live allocator numbers — on the card the allocator's
peak of the step before (``torch.cuda.max_memory_allocated``), or the
dry-run-schema records ``repro_torch.launch.measure`` writes (its
``memory`` block), in tests any injectable step -> bytes source — and
maintains an EWMA of the observed / predicted ratio against the
calibrated :class:`~repro_torch.core.predictor.PredictedMemory` peak of
the current cell.
Each observation is classified:

* ``UNAVAILABLE`` — no usable telemetry this step (missing artifact,
  truncated metric dump, zero/negative counters).  Deliberately NOT
  ``SAFE``: a blind autopilot must not report health it cannot see.
* ``SAFE``       — projected peak comfortably inside the budget.
* ``DRIFT``      — observed usage runs persistently above the
  prediction (EWMA ratio past ``drift_tolerance``) or the projection
  has entered the guard band below the budget.
* ``CRITICAL``   — the projected peak meets or exceeds the budget: the
  next allocation spike is an OOM abort.

``projected_bytes = max(observed, ewma * predicted)`` is the quantity
classified — the EWMA arm catches slow leaks the newest sample alone
would understate, the raw arm catches spikes faster than the EWMA can
follow.
"""

from __future__ import annotations

import enum
import json
import os
from dataclasses import dataclass, field
from typing import Optional


class WatchState(enum.Enum):
    UNAVAILABLE = "unavailable"
    SAFE = "safe"
    DRIFT = "drift"
    CRITICAL = "critical"

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return self.value


# -- allocator-stat ingest ---------------------------------------------------

_COUNTERS = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes")


def observed_bytes(record) -> Optional[int]:
    """Per-device peak bytes out of one dryrun artifact record, or None
    when the telemetry is unusable (the "telemetry unavailable" state —
    never a crash, never a bogus zero that would read as SAFE).

    Accepts the ``record["memory"]`` dict of a dry-run-schema record (the
    reference's ``repro.launch.dryrun`` artifacts, the port's
    ``launch.measure`` records) or the full record.  A serialized
    ``total_bytes`` wins; otherwise the total is rebuilt from the four
    allocator counters as the reference's ``MemoryStats.total_bytes``
    does (argument + temp + output - alias).  Missing counters,
    non-numeric values and non-positive totals all yield None.
    """
    if not isinstance(record, dict):
        return None
    mem = record.get("memory", record)
    if not isinstance(mem, dict):
        return None
    total = mem.get("total_bytes")
    if total is None:
        try:
            total = (int(mem["argument_bytes"]) + int(mem["temp_bytes"])
                     + int(mem["output_bytes"]) - int(mem["alias_bytes"]))
        except (KeyError, TypeError, ValueError):
            return None
    try:
        total = int(total)
    except (TypeError, ValueError):
        return None
    return total if total > 0 else None


def telemetry_defect(record) -> Optional[str]:
    """Human-readable reason ``observed_bytes(record)`` returned None —
    the defect matrix, named.  None when the record is usable.  Ingest
    paths (calibrate.measurements.from_dryrun_record) use this to raise
    errors that say WHICH defect poisoned the sample."""
    if not isinstance(record, dict):
        return f"record is {type(record).__name__}, not a dict"
    mem = record.get("memory", record)
    if not isinstance(mem, dict):
        return "memory block is not a dict"
    total = mem.get("total_bytes")
    if total is None:
        missing = [c for c in _COUNTERS if c not in mem]
        if missing:
            return (f"no total_bytes and allocator counters "
                    f"{missing} missing")
        try:
            total = (int(mem["argument_bytes"]) + int(mem["temp_bytes"])
                     + int(mem["output_bytes"]) - int(mem["alias_bytes"]))
        except (TypeError, ValueError):
            return "no total_bytes and non-numeric allocator counters"
    try:
        total = int(total)
    except (TypeError, ValueError):
        return f"non-numeric total_bytes {total!r}"
    if total <= 0:
        return f"non-positive total ({total} bytes)"
    return None


def load_dryrun(path: str) -> Optional[int]:
    """Observed bytes from a dryrun artifact file; None on any defect
    (missing file, truncated JSON, missing counters, zero peak)."""
    try:
        with open(path) as f:
            record = json.load(f)
    except (OSError, ValueError):
        return None
    return observed_bytes(record)


def scan_dryrun_dir(dirname: str) -> list:
    """(filename, observed_bytes_or_None) for every artifact in a dryrun
    directory, sorted by name; tolerates a missing directory."""
    try:
        names = sorted(n for n in os.listdir(dirname)
                       if n.endswith(".json"))
    except OSError:
        return []
    return [(n, load_dryrun(os.path.join(dirname, n))) for n in names]


# -- the watch ---------------------------------------------------------------


@dataclass(frozen=True)
class WatchSample:
    """One classified observation."""

    step: int
    state: WatchState
    observed_bytes: Optional[int]
    predicted_bytes: int
    projected_bytes: int
    budget_bytes: int
    ewma_ratio: float

    @property
    def headroom_bytes(self) -> int:
        return max(0, self.budget_bytes - self.projected_bytes)


@dataclass
class MemoryWatch:
    """EWMA drift detector over observed vs predicted peak memory."""

    predicted_bytes: int
    budget_bytes: int
    drift_tolerance: float = 1.05   # EWMA ratio past this => DRIFT
    guard_frac: float = 0.95        # projection past this * budget => DRIFT
    ewma_alpha: float = 0.25
    # continual-refit hook (repro_torch.calibrate.learned): every USABLE
    # observation is also appended to ``store`` (a
    # calibrate.measurements.MeasurementStore) as the Measurement built
    # by ``measurement_of(step, observed_bytes)`` — the guard's refit
    # trigger fits the learned residual model from exactly these
    # samples.  Both default to None (no accumulation).
    store: Optional[object] = None
    measurement_of: Optional[object] = None

    ewma_ratio: float = 1.0
    samples: list = field(default_factory=list)

    def __post_init__(self):
        if self.predicted_bytes <= 0:
            raise ValueError("predicted_bytes must be positive")
        if self.budget_bytes <= 0:
            raise ValueError("budget_bytes must be positive")

    def repredict(self, predicted_bytes: int,
                  reset_ewma: bool = True) -> None:
        """Point the watch at a new cell's prediction (after a
        mitigation changed the knobs).  The EWMA resets by default: the
        old ratio measured the OLD cell's model error."""
        if predicted_bytes <= 0:
            raise ValueError("predicted_bytes must be positive")
        self.predicted_bytes = int(predicted_bytes)
        if reset_ewma:
            self.ewma_ratio = 1.0

    def classify(self, observed: Optional[int]) -> WatchState:
        """Stateless classification of a single observation against the
        CURRENT ewma (used by observe after the EWMA update)."""
        if observed is None or observed <= 0:
            return WatchState.UNAVAILABLE
        projected = self.project(observed)
        if projected >= self.budget_bytes:
            return WatchState.CRITICAL
        if (self.ewma_ratio > self.drift_tolerance
                or projected > self.guard_frac * self.budget_bytes):
            return WatchState.DRIFT
        return WatchState.SAFE

    def project(self, observed: int) -> int:
        return max(int(observed),
                   int(self.ewma_ratio * self.predicted_bytes))

    def observe(self, step: int, observed: Optional[int]) -> WatchSample:
        """Fold one telemetry sample in and classify it.  Unusable
        telemetry leaves the EWMA untouched (no observation, no
        update) and comes back UNAVAILABLE."""
        obs = observed_bytes(observed) if isinstance(observed, dict) \
            else observed
        if obs is not None and obs > 0:
            ratio = obs / self.predicted_bytes
            a = self.ewma_alpha
            self.ewma_ratio = (1 - a) * self.ewma_ratio + a * ratio
            projected = self.project(obs)
            if self.store is not None and self.measurement_of is not None:
                self.store.add(self.measurement_of(int(step), int(obs)))
        else:
            obs = None
            projected = int(self.ewma_ratio * self.predicted_bytes)
        sample = WatchSample(step=int(step), state=self.classify(obs),
                             observed_bytes=obs,
                             predicted_bytes=self.predicted_bytes,
                             projected_bytes=projected,
                             budget_bytes=self.budget_bytes,
                             ewma_ratio=self.ewma_ratio)
        self.samples.append(sample)
        return sample
