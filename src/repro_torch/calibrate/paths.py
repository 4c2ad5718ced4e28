"""Repo-anchored artifact paths shared by the measurement pipeline.

The JAX package's dry-run writer (``python -m repro.launch.dryrun``) and
this package's calibration ``MeasurementStore`` (the artifact reader) must
agree on where dry-run records live: both packages sit under the same
``src/``, so this module resolves to the same repository root, and
``experiments/`` is shared.  Import-light on purpose: no torch, no other
module of the package.
"""

from __future__ import annotations

from pathlib import Path


def repo_root() -> Path:
    """The repository root (parent of ``src/``), resolved from this file:
    src/repro_torch/calibrate/paths.py -> three levels up."""
    return Path(__file__).resolve().parents[3]


def experiments_dir() -> Path:
    return repo_root() / "experiments"


def dryrun_dir() -> Path:
    """Where the dry-run harness writes its artifacts and where
    ``MeasurementStore.ingest_dryrun_dir`` reads them by default."""
    return experiments_dir() / "dryrun"


def profiles_dir() -> Path:
    """Default home of fitted CalibrationProfile JSON files."""
    return experiments_dir() / "profiles"
