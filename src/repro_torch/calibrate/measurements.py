"""Measured peak-memory samples and their on-disk store.

A :class:`Measurement` is one observed (configuration -> peak bytes) pair
— from an XLA dry-run artifact (``launch/dryrun.py``), a real step on the
card (``repro_torch.launch.measure``), or the deterministic synthetic generator (``repro_torch.calibrate.synthetic``).
It carries exactly the fields :func:`repro_torch.core.planner.make_context`
needs to rebuild the prediction context, so the residual decomposition
can recompute every Eq.1 term for the same cell.

:class:`MeasurementStore` is a list-shaped container with versioned JSON
(de)serialization and a dry-run artifact ingester.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field, asdict
from pathlib import Path
from typing import Iterator, Optional

from repro_torch.calibrate.paths import dryrun_dir

SCHEMA_VERSION = 1
STORE_KIND = "measurement_store"

# dryrun artifacts name meshes by shape string ("16x16", "2x16x16"); the
# launch-mesh naming convention maps the factors back to named axes:
# make_production_mesh builds (data, model) meshes and prefixes a "pod"
# axis for multi-pod 3-d shapes (repro_torch.launch.mesh).
_MESH_AXES_BY_RANK = {2: ("data", "model"), 3: ("pod", "data", "model")}


def parse_mesh_string(mesh: str) -> dict:
    """``"AxB"``/``"AxBxC"`` -> named mesh-shape dict under the
    launch-mesh axis convention.  Raises ValueError on anything else —
    a mesh the convention cannot name must not be guessed at."""
    parts = str(mesh).split("x")
    axes = _MESH_AXES_BY_RANK.get(len(parts))
    if axes is None:
        raise ValueError(
            f"mesh string {mesh!r} has {len(parts)} factor(s); the "
            f"launch-mesh convention names only AxB (data x model) and "
            f"AxBxC (pod x data x model) shapes — write the artifact "
            f"with an explicit mesh_shape dict instead")
    try:
        sizes = [int(p) for p in parts]
    except ValueError:
        raise ValueError(f"mesh string {mesh!r} has non-integer factors")
    if any(s <= 0 for s in sizes):
        raise ValueError(f"mesh string {mesh!r} has non-positive factors")
    return dict(zip(axes, sizes))


@dataclass
class Measurement:
    """One measured cell.  ``optimizer``/``remat`` of None mean "the
    architecture's default" (same convention as the sweep grid)."""

    arch: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int
    mesh_shape: dict
    measured_bytes: int
    backend: str = "cpu"
    chip: Optional[str] = None     # None: no chip constant applies
    optimizer: Optional[str] = None
    remat: Optional[str] = None
    grad_accum: int = 1
    policy: str = "full"           # key into repro_torch.core.sweep.POLICIES
    # pipeline/offload knobs (schema-v1 stores lack them; the defaults
    # reproduce the pre-knob decomposition: one microbatch, 1F1B, no
    # offload).  A pipelined or offloaded cell measured without these
    # fields would decompose against the WRONG cell — see _context_for.
    microbatches: int = 1
    schedule: str = "1f1b"
    offload_optimizer: bool = False
    source: str = ""               # provenance: dryrun path / "synthetic"
    meta: dict = field(default_factory=dict)

    @property
    def key(self) -> tuple:
        """Stable identity of the measured cell (not the measured value).
        Includes every knob make_context reads — two cells differing only
        in microbatches/schedule/offload must never collide."""
        return (self.arch, self.kind, self.seq_len, self.global_batch,
                tuple(sorted(self.mesh_shape.items())), self.backend,
                self.chip, self.optimizer, self.remat, self.grad_accum,
                self.policy, self.microbatches, self.schedule,
                self.offload_optimizer)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Measurement":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})

    @classmethod
    def from_dryrun_record(cls, record: dict,
                           source: str = "") -> "Measurement":
        """Ingest one dry-run-schema artifact: the reference's
        ``launch/dryrun.py`` records or the card's
        (``repro_torch.launch.measure``).  The allocator / XLA total is the
        ground truth whose overflow aborts a job; the prediction block in
        the artifact is ignored (we recompute it).

        A record that carries its own cell (``seq_len``, ``global_batch``,
        ``backend``, ``chip``, ``optimizer``, ``remat``, ``policy``,
        ``grad_accum``: the card's do) is read from those fields; where a
        field is absent the reference's rule holds — the shape from
        ``SHAPES[record["shape"]]``, ``backend="cpu"`` (the dry run
        compiles on the cpu oracle), the dataclass defaults — so every
        dry-run artifact ingests to the reference's Measurement.

        The total goes through the same telemetry defect matrix the
        autopilot watch applies (``autopilot.watch.observed_bytes``): a
        missing ``total_bytes`` is rebuilt from the four allocator
        counters, and an unusable record (missing counters, non-numeric
        values, non-positive total) raises a ValueError naming the defect
        — a zero/negative peak must never enter a fit as ground truth."""
        from repro_torch.autopilot.watch import observed_bytes, telemetry_defect
        from repro_torch.configs import SHAPES
        mesh = record.get("mesh_shape")
        if mesh is None:
            mesh = parse_mesh_string(record.get("mesh", ""))
        measured = observed_bytes(record)
        if measured is None:
            raise ValueError(
                f"dryrun record {source or '<record>'} has unusable "
                f"memory telemetry: {telemetry_defect(record)}")
        if "seq_len" in record and "global_batch" in record:
            seq_len, global_batch = record["seq_len"], record["global_batch"]
            kind = record["kind"]
        else:
            shape = SHAPES[record["shape"]]
            seq_len, global_batch = shape.seq_len, shape.global_batch
            kind = record.get("kind", shape.kind)
        meta = {"shape": record["shape"],
                "compile_seconds": record.get("compile_seconds")}
        if "device" in record:
            meta["device"] = record["device"]
        return cls(
            arch=record["arch"], kind=kind,
            seq_len=int(seq_len), global_batch=int(global_batch),
            mesh_shape=dict(mesh),
            measured_bytes=measured,
            backend=str(record.get("backend", "cpu")),
            chip=record.get("chip"),
            optimizer=record.get("optimizer"),
            remat=record.get("remat"),
            grad_accum=int(record.get("grad_accum", 1)),
            policy=str(record.get("policy", "full")),
            microbatches=int(record.get("microbatches", 1)),
            schedule=str(record.get("schedule", "1f1b")),
            offload_optimizer=bool(record.get("offload_optimizer",
                                              False)),
            source=source or "dryrun",
            meta=meta)


@dataclass
class MeasurementStore:
    measurements: list = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.measurements)

    def __iter__(self) -> Iterator[Measurement]:
        return iter(self.measurements)

    def add(self, m: Measurement) -> None:
        self.measurements.append(m)

    def extend(self, ms) -> None:
        self.measurements.extend(ms)

    def archs(self) -> list[str]:
        return sorted({m.arch for m in self.measurements})

    def chips(self) -> list[str]:
        return sorted({m.chip for m in self.measurements if m.chip})

    def by_arch(self) -> dict:
        out: dict[str, list[Measurement]] = {}
        for m in self.measurements:
            out.setdefault(m.arch, []).append(m)
        return out

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        return {"schema_version": SCHEMA_VERSION, "kind": STORE_KIND,
                "measurements": [m.to_dict() for m in self.measurements]}

    @classmethod
    def from_dict(cls, d: dict) -> "MeasurementStore":
        if d.get("kind") != STORE_KIND:
            raise ValueError(f"not a measurement store "
                             f"(kind={d.get('kind')!r})")
        if d.get("schema_version") != SCHEMA_VERSION:
            raise ValueError(
                f"measurement store schema_version "
                f"{d.get('schema_version')!r} != {SCHEMA_VERSION}")
        return cls([Measurement.from_dict(m) for m in d["measurements"]])

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=1,
                                   sort_keys=True) + "\n")
        return path

    @classmethod
    def load(cls, path) -> "MeasurementStore":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- dryrun ingest -------------------------------------------------------
    @classmethod
    def ingest_dryrun_dir(cls, path=None,
                          strict: bool = False) -> "MeasurementStore":
        """Scan a dry-run artifact directory (default: the shared
        ``experiments/dryrun`` the dryrun CLI writes to) into a store.
        Unreadable / non-artifact JSON files are skipped unless
        ``strict``."""
        path = Path(path) if path is not None else dryrun_dir()
        store = cls()
        for fn in sorted(glob.glob(os.path.join(str(path), "*.json"))):
            try:
                with open(fn) as f:
                    record = json.load(f)
                store.add(Measurement.from_dryrun_record(
                    record, source=os.path.basename(fn)))
            except (KeyError, TypeError, ValueError, json.JSONDecodeError):
                if strict:
                    raise
        return store
