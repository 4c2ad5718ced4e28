"""Telemetry ingest for the memory autopilot — the part that exists so far.

Holds only the allocator-stat ingest: ``observed_bytes`` reads the
per-device peak out of one dry-run artifact record (or its ``memory``
block), and ``telemetry_defect`` names why a record is unusable.  The
calibration pipeline (``repro_torch.calibrate.measurements``) ingests
measurements through them.  The rest of the watch — the EWMA drift
classifier, the guard, the mitigations and the harness — is the autopilot
item of ROADMAP (A6) and is not here yet.
"""

from __future__ import annotations

from typing import Optional

# -- allocator-stat ingest ---------------------------------------------------

_COUNTERS = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes")


def observed_bytes(record) -> Optional[int]:
    """Per-device peak bytes out of one dryrun artifact record, or None
    when the telemetry is unusable (the "telemetry unavailable" state —
    never a crash, never a bogus zero that would read as SAFE).

    Accepts the ``record["memory"]`` dict written by
    ``repro.launch.dryrun`` (or the full record).  A serialized
    ``total_bytes`` wins; otherwise the total is rebuilt from the four
    allocator counters exactly like
    :meth:`repro.core.xla_metrics.MemoryStats.total_bytes`.  Missing
    counters, non-numeric values and non-positive totals all yield None.
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
