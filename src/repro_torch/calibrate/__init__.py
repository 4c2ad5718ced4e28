"""Measurement-driven calibration of the analytic memory predictor.

Closes the loop the paper's evaluation opens: dry-run/real measurements
flow into a :class:`MeasurementStore`, the prediction-vs-measured residual
is decomposed per Eq.1 component group, a :class:`CalibrationProfile`
(per-term multiplicative coefficients + per-chip constant overhead) is
fitted by non-negative least squares, and the profile threads through
``predictor.assemble`` / ``planner.check`` / the sweep engine so every
verdict can be measurement-corrected.

    python -m repro_torch.calibrate fit --synthetic --out profile.json
    python -m repro_torch.calibrate report --profile profile.json --synthetic
    python -m repro_torch.calibrate apply --profile profile.json \
        --arch llava15-7b --mesh data=8,model=2 --chip v5e

See docs/calibration.md for the walkthrough and the JSON schemas.

Exports resolve lazily (PEP 562) so light consumers that import only
``repro_torch.calibrate.paths`` for the shared artifact-directory
resolution never pay for (or depend on) the fit/report stack's imports.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "fit_profile": "repro_torch.calibrate.fit",
    "fit_rows": "repro_torch.calibrate.fit",
    "nnls": "repro_torch.calibrate.fit",
    "ridge": "repro_torch.calibrate.fit",
    "FEATURE_NAMES": "repro_torch.calibrate.learned",
    "ResidualModel": "repro_torch.calibrate.learned",
    "apply_residual": "repro_torch.calibrate.learned",
    "features_from": "repro_torch.calibrate.learned",
    "fit_residual": "repro_torch.calibrate.learned",
    "leave_one_family_out": "repro_torch.calibrate.learned",
    "residual_hash_of": "repro_torch.calibrate.learned",
    "parse_mesh_string": "repro_torch.calibrate.measurements",
    "Measurement": "repro_torch.calibrate.measurements",
    "MeasurementStore": "repro_torch.calibrate.measurements",
    "dryrun_dir": "repro_torch.calibrate.paths",
    "profiles_dir": "repro_torch.calibrate.paths",
    "repo_root": "repro_torch.calibrate.paths",
    "TERMS": "repro_torch.calibrate.profile",
    "CalibrationProfile": "repro_torch.calibrate.profile",
    "AccuracyReport": "repro_torch.calibrate.report",
    "evaluate": "repro_torch.calibrate.report",
    "TermRow": "repro_torch.calibrate.residual",
    "decompose": "repro_torch.calibrate.residual",
    "predict_measurement": "repro_torch.calibrate.residual",
    "SYNTHETIC_ARCHS": "repro_torch.calibrate.synthetic",
    "TRUE_PROFILE": "repro_torch.calibrate.synthetic",
    "generate": "repro_torch.calibrate.synthetic",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.calibrate' has no attribute {name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value        # cache for subsequent lookups
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
