"""Paper-style accuracy evaluation: per-group MAPE, calibrated vs raw.

``evaluate(store, profile)`` predicts every measured cell twice — once
uncalibrated, once through the profile — and aggregates absolute
percentage errors against the measured peaks into the paper's evaluation
table, grouped by architecture or by family.  Passing a learned
``residual`` model adds a third series (profile + residual correction).
Output goes through the :mod:`repro_torch.core.report` writers (markdown /
CSV / the MAPE arithmetic), so this table and the paper-repro benchmarks
render identically.

Records with no usable ground truth (``measured_bytes <= 0``) are
excluded from every aggregate and surfaced as ``n_excluded`` — a
defective zero-measured cell must never read as a perfect prediction.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.calibrate.measurements import MeasurementStore
from repro_torch.calibrate.profile import CalibrationProfile
from repro_torch.calibrate.residual import predict_measurement
from repro_torch.core import report as RPT

GiB = 1024 ** 3


@dataclass
class AccuracyRow:
    group: str
    n: int
    mape_raw: float
    mape_calibrated: float
    mape_learned: Optional[float] = None   # profile + residual model

    @property
    def improvement_pp(self) -> float:
        return self.mape_raw - self.mape_calibrated


@dataclass
class AccuracyReport:
    by: str                        # "arch" | "family"
    profile_hash: str
    rows: list = field(default_factory=list)
    mape_raw: float = 0.0
    mape_calibrated: float = 0.0
    mape_learned: Optional[float] = None
    residual_hash: Optional[str] = None
    n: int = 0
    n_excluded: int = 0            # defective (zero/negative) measurements

    @property
    def _has_learned(self) -> bool:
        return self.mape_learned is not None

    def to_markdown(self, title: str = "") -> str:
        headers = ["group", "cells", "MAPE raw %", "MAPE calibrated %",
                   "improvement pp"]
        if self._has_learned:
            headers.append("MAPE learned %")
        body = []
        for r in self.rows:
            row = [r.group, r.n, f"{r.mape_raw:.2f}",
                   f"{r.mape_calibrated:.2f}", f"{r.improvement_pp:+.2f}"]
            if self._has_learned:
                row.append("" if r.mape_learned is None
                           else f"{r.mape_learned:.2f}")
            body.append(tuple(row))
        total = ["ALL", self.n, f"{self.mape_raw:.2f}",
                 f"{self.mape_calibrated:.2f}",
                 f"{self.mape_raw - self.mape_calibrated:+.2f}"]
        if self._has_learned:
            total.append(f"{self.mape_learned:.2f}")
        body.append(tuple(total))
        out = RPT.markdown_table(
            headers, body,
            title=title or f"calibration accuracy by {self.by} "
                           f"(profile {self.profile_hash})")
        if self.n_excluded:
            out += (f"\n\n{self.n_excluded} measurement(s) excluded "
                    f"(no usable ground truth)")
        return out

    def to_csv(self) -> str:
        headers = ["group", "cells", "mape_raw_pct", "mape_calibrated_pct"]
        if self._has_learned:
            headers.append("mape_learned_pct")
        body = []
        for r in self.rows:
            row = [r.group, r.n, f"{r.mape_raw:.3f}",
                   f"{r.mape_calibrated:.3f}"]
            if self._has_learned:
                row.append("" if r.mape_learned is None
                           else f"{r.mape_learned:.3f}")
            body.append(tuple(row))
        total = ["ALL", self.n, f"{self.mape_raw:.3f}",
                 f"{self.mape_calibrated:.3f}"]
        if self._has_learned:
            total.append(f"{self.mape_learned:.3f}")
        body.append(tuple(total))
        return RPT.csv_table(headers, body)

    def to_json_dict(self) -> dict:
        out = {
            "by": self.by,
            "profile_hash": self.profile_hash,
            "n_measurements": self.n,
            "n_excluded": self.n_excluded,
            "mape_raw_pct": round(self.mape_raw, 4),
            "mape_calibrated_pct": round(self.mape_calibrated, 4),
            "groups": {r.group: {
                "n": r.n,
                "mape_raw_pct": round(r.mape_raw, 4),
                "mape_calibrated_pct": round(r.mape_calibrated, 4),
                **({"mape_learned_pct": round(r.mape_learned, 4)}
                   if r.mape_learned is not None else {}),
            } for r in self.rows},
        }
        if self._has_learned:
            out["mape_learned_pct"] = round(self.mape_learned, 4)
            out["residual_hash"] = self.residual_hash
        return out

    def save_json(self, path) -> None:
        from pathlib import Path
        Path(path).write_text(
            json.dumps(self.to_json_dict(), indent=1, sort_keys=True)
            + "\n")

    @property
    def all_groups_improved(self) -> bool:
        return all(r.mape_calibrated < r.mape_raw for r in self.rows)


def _family_of(arch: str) -> str:
    from repro_torch.configs import get_config
    return get_config(arch).family


def evaluate(store: MeasurementStore,
             profile: CalibrationProfile,
             by: str = "family",
             engine=None, assembly: str = "legacy",
             residual=None) -> AccuracyReport:
    """Per-group MAPE of raw vs calibrated (vs learned) predictions."""
    if by not in ("arch", "family"):
        raise ValueError(f"by={by!r}; expected 'arch' or 'family'")
    from repro_torch.core import sweep as SW
    engine = engine or SW.SweepEngine()
    raw_groups: dict[str, list] = {}
    cal_groups: dict[str, list] = {}
    lrn_groups: dict[str, list] = {}
    raw_all: list = []
    cal_all: list = []
    lrn_all: list = []
    n_excluded = 0
    for m in store:
        if m.measured_bytes <= 0:
            n_excluded += 1
            continue
        group = m.arch if by == "arch" else _family_of(m.arch)
        raw = predict_measurement(m, engine, assembly=assembly)
        cal = predict_measurement(m, engine, profile=profile,
                                  assembly=assembly)
        label = f"{m.arch}|{m.kind}|b{m.global_batch}|s{m.seq_len}"
        r_rec = RPT.PredictionRecord(label, raw.peak_bytes,
                                     m.measured_bytes)
        c_rec = RPT.PredictionRecord(label, cal.peak_bytes,
                                     m.measured_bytes)
        raw_groups.setdefault(group, []).append(r_rec)
        cal_groups.setdefault(group, []).append(c_rec)
        raw_all.append(r_rec)
        cal_all.append(c_rec)
        if residual is not None:
            lrn = predict_measurement(m, engine, profile=profile,
                                      assembly=assembly,
                                      residual=residual)
            l_rec = RPT.PredictionRecord(label, lrn.peak_bytes,
                                         m.measured_bytes)
            lrn_groups.setdefault(group, []).append(l_rec)
            lrn_all.append(l_rec)
    cal_by_group = dict(
        (g, mp) for g, _, mp in RPT.grouped_mape(cal_groups))
    lrn_by_group = dict(
        (g, mp) for g, _, mp in RPT.grouped_mape(lrn_groups))
    rows = [AccuracyRow(group=g, n=n, mape_raw=mp,
                        mape_calibrated=cal_by_group[g],
                        mape_learned=lrn_by_group.get(g))
            for g, n, mp in RPT.grouped_mape(raw_groups)]
    return AccuracyReport(by=by, profile_hash=profile.profile_hash,
                          rows=rows, mape_raw=RPT.mape(raw_all),
                          mape_calibrated=RPT.mape(cal_all),
                          mape_learned=(RPT.mape(lrn_all)
                                        if residual is not None else None),
                          residual_hash=(residual.model_hash
                                         if residual is not None else None),
                          n=len(raw_all), n_excluded=n_excluded)
