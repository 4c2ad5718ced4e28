"""Learned per-arch-family residual calibration (ROADMAP item 1.ii).

The affine :class:`~repro_torch.calibrate.profile.CalibrationProfile` is four
multiplicative coefficients + per-chip constants — it cannot express
structure that varies with the KNOBS of a cell (a seq-length-dependent
allocator reservation, a per-family activation bias).  This module fits
a small regularized linear model per architecture family over

* Eq.1 term-byte features — the four profile-term group bytes of the
  (profile-applied) prediction, in GiB, and
* knob features — step kind, remat policy, optimizer class, pipeline
  degree / microbatch count, optimizer offload, and the seq bucket

to predict the residual bytes left AFTER the affine profile applies.
Families with too few samples (or whose fitted weights do not improve
their own in-sample MAPE — the fit is self-guarding) fall back to a
global model fitted over all rows; a family can therefore never be made
WORSE than affine-only by its own refit.

A :class:`ResidualModel` serializes to versioned JSON under the same
staleness rules as a profile (kind / schema_version / feature-set match,
plus a binding to the ``profile_hash`` it was fitted on top of), and its
``model_hash`` participates in the sweep engine's memo keys exactly like
``profile_hash`` — no model active means every prediction stays
bit-identical to the uncorrected path.

Continual refit: :class:`~repro_torch.autopilot.watch.MemoryWatch` samples
accumulate into a :class:`~repro_torch.calibrate.measurements.MeasurementStore`
and :class:`~repro_torch.autopilot.guard.Autopilot` refits mid-run on
persistent DRIFT — see docs/calibration.md ("Learned residual model").
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from repro_torch.calibrate.measurements import MeasurementStore
from repro_torch.calibrate.profile import profile_hash_of

SCHEMA_VERSION = 1
MODEL_KIND = "residual_model"

GiB = 1024 ** 3

#: feature vector layout, in order.  Loading a model fitted against a
#: different feature set fails (same staleness contract as profile TERMS).
FEATURE_NAMES = (
    "const",
    "static_gib", "act_saved_gib", "act_transient_gib", "overhead_gib",
    "kind_train", "kind_prefill", "kind_decode",
    "remat_none", "remat_dots", "remat_block",
    "opt_master_fp32", "opt_8bit",
    "log2_pp", "log2_microbatches",
    "offload_opt",
    "seq_bucket",
)

#: a family needs at least this many rows for its own weights; below it
#: the rows still train the global fallback
MIN_FAMILY_ROWS = 4


def features_from(pred, ctx) -> list:
    """The model's feature vector for one (prediction, context) pair.

    Used identically at fit time (contexts rebuilt from measurements via
    ``residual._context_for``) and at apply time (the live sweep/planner
    context) — the two paths can never disagree on featurization.
    ``pred`` must be the prediction the residual corrects, i.e. with the
    affine profile already applied."""
    static = (pred.param_bytes + pred.grad_bytes + pred.opt_bytes
              + pred.output_copy_bytes)
    overhead = pred.loss_bytes + pred.input_bytes + pred.cache_bytes
    opt = ctx.optimizer or ""
    return [
        1.0,
        static / GiB, pred.act_saved_bytes / GiB,
        pred.act_transient_bytes / GiB, overhead / GiB,
        1.0 if ctx.kind == "train" else 0.0,
        1.0 if ctx.kind == "prefill" else 0.0,
        1.0 if ctx.kind == "decode" else 0.0,
        1.0 if ctx.remat == "none" else 0.0,
        1.0 if ctx.remat == "dots" else 0.0,
        1.0 if ctx.remat == "block" else 0.0,
        1.0 if ctx.master_fp32 else 0.0,
        1.0 if "8bit" in opt else 0.0,
        math.log2(max(ctx.pp, 1)),
        math.log2(max(ctx.eff_microbatches, 1)),
        1.0 if ctx.offload_opt else 0.0,
        math.log2(max(ctx.seq_len, 1)),
    ]


@dataclass(frozen=True)
class ResidualModel:
    """Immutable per-family linear residual corrector.

    ``families`` maps an arch-family name to its weight vector (one
    float per FEATURE_NAMES entry, GiB scale); ``global_weights`` is the
    all-family fallback used for families without their own entry (e.g.
    a family held out of the fit).  ``base_profile_hash`` binds the
    model to the affine profile it was fitted on top of — applying it
    over any other profile raises (staleness rule: the residual is
    defined relative to ONE calibrated prediction)."""

    families: dict = field(default_factory=dict)
    global_weights: Optional[tuple] = None
    base_profile_hash: Optional[str] = None
    created: str = ""
    source: dict = field(default_factory=dict)
    fit_info: dict = field(default_factory=dict)

    def __post_init__(self):
        for fam, w in self.families.items():
            if len(w) != len(FEATURE_NAMES):
                raise ValueError(
                    f"family {fam!r} has {len(w)} weights; the current "
                    f"feature set has {len(FEATURE_NAMES)}")
        if self.global_weights is not None \
                and len(self.global_weights) != len(FEATURE_NAMES):
            raise ValueError(
                f"global weights have {len(self.global_weights)} "
                f"entries; the current feature set has "
                f"{len(FEATURE_NAMES)}")

    # -- identity ------------------------------------------------------------
    @classmethod
    def identity(cls, base_profile_hash: Optional[str] = None
                 ) -> "ResidualModel":
        """The all-zero-correction model: bit-inert on every prediction."""
        return cls(base_profile_hash=base_profile_hash)

    @property
    def is_identity(self) -> bool:
        return not self.families and self.global_weights is None

    # -- application ---------------------------------------------------------
    def weights_for(self, family: str) -> Optional[tuple]:
        w = self.families.get(family)
        return w if w is not None else self.global_weights

    def residual_bytes(self, family: str, feats) -> int:
        """Predicted leftover bytes (may be negative) for one cell."""
        w = self.weights_for(family)
        if w is None:
            return 0
        gib = sum(float(a) * float(b) for a, b in zip(w, feats))
        return int(round(gib * GiB))

    # -- identity/serialization ---------------------------------------------
    def to_dict(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "kind": MODEL_KIND,
            "features": list(FEATURE_NAMES),
            "families": {f: [float(x) for x in w] for f, w in
                         sorted(self.families.items())},
            "global": ([float(x) for x in self.global_weights]
                       if self.global_weights is not None else None),
            "base_profile_hash": self.base_profile_hash,
            "created": self.created,
            "source": self.source,
            "fit": self.fit_info,
        }

    @property
    def model_hash(self) -> str:
        """Digest of the prediction-changing payload ONLY (not
        metadata); participates in the sweep engine's memo keys exactly
        like ``profile_hash``."""
        payload = {
            "schema_version": SCHEMA_VERSION,
            "features": list(FEATURE_NAMES),
            "families": {f: [float(x) for x in w] for f, w in
                         sorted(self.families.items())},
            "global": ([float(x) for x in self.global_weights]
                       if self.global_weights is not None else None),
            "base_profile_hash": self.base_profile_hash,
        }
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    @classmethod
    def from_dict(cls, d: dict) -> "ResidualModel":
        if d.get("kind") != MODEL_KIND:
            raise ValueError(
                f"not a residual model (kind={d.get('kind')!r})")
        if d.get("schema_version") != SCHEMA_VERSION:
            raise ValueError(
                f"residual model schema_version "
                f"{d.get('schema_version')!r} != supported "
                f"{SCHEMA_VERSION}; re-fit with "
                f"`python -m repro_torch.calibrate fit-residual` "
                f"(docs/calibration.md)")
        if tuple(d.get("features", ())) != FEATURE_NAMES:
            raise ValueError(
                f"residual model features {d.get('features')} do not "
                f"match the current feature set {list(FEATURE_NAMES)}; "
                f"the model is stale — re-fit against fresh "
                f"measurements")
        g = d.get("global")
        return cls(families={f: tuple(w) for f, w in
                             d.get("families", {}).items()},
                   global_weights=tuple(g) if g is not None else None,
                   base_profile_hash=d.get("base_profile_hash"),
                   created=d.get("created", ""),
                   source=dict(d.get("source", {})),
                   fit_info=dict(d.get("fit", {})))

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=1,
                                   sort_keys=True) + "\n")
        return path

    @classmethod
    def load(cls, path) -> "ResidualModel":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def summary(self) -> str:
        fams = ", ".join(sorted(self.families)) or "none"
        return (f"ResidualModel[{self.model_hash}] families: {fams}; "
                f"global fallback: "
                f"{'yes' if self.global_weights is not None else 'no'}; "
                f"base profile: {self.base_profile_hash or 'raw'}")


def residual_hash_of(model: Optional[ResidualModel]) -> Optional[str]:
    """Memo-key helper: None for the uncorrected path."""
    return None if model is None else model.model_hash


def apply_residual(pred, model: ResidualModel, family: str, ctx,
                   profile=None):
    """Residual-corrected copy of a PredictedMemory.

    Applied AFTER the affine profile and after the pipeline worst-stage
    max — the model corrects the composed per-device peak, the thing a
    measurement observes.  Raises when ``model`` was fitted over a
    different profile than the one active (the correction would be
    defined relative to the wrong baseline)."""
    phash = profile_hash_of(profile)
    if model.base_profile_hash != phash:
        raise ValueError(
            f"residual model {model.model_hash} was fitted over profile "
            f"{model.base_profile_hash or 'raw'} but is being applied "
            f"over {phash or 'raw'}; re-fit the residual against the "
            f"active profile (docs/calibration.md)")
    rb = model.residual_bytes(family, features_from(pred, ctx))
    if rb == 0:
        return pred
    return dataclasses.replace(pred, residual_bytes=rb)


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResidualRow:
    """One fit-ready sample: features + target residual, both GiB."""

    family: str
    features: tuple
    residual_gib: float            # measured - calibrated peak
    measured_bytes: int
    calibrated_bytes: int

    @property
    def ape_base(self) -> float:
        """Affine-only absolute percentage error of this row."""
        return abs(self.calibrated_bytes - self.measured_bytes) \
            / self.measured_bytes * 100.0

    def ape_with(self, weights) -> float:
        gib = sum(float(a) * float(b) for a, b in
                  zip(weights, self.features))
        corrected = self.calibrated_bytes + int(round(gib * GiB))
        return abs(corrected - self.measured_bytes) \
            / self.measured_bytes * 100.0


def residual_rows(store: MeasurementStore, profile=None, engine=None,
                  assembly: str = "legacy") -> list:
    """Feature/target rows for every usable measurement in ``store``.

    Predictions go through the shared memoized engine WITH the affine
    profile applied — the target is exactly the residual the learned
    model is asked to mop up.  Zero/negative measured peaks are skipped
    (the same defect rule core.report.mape applies)."""
    from repro_torch.calibrate.residual import _context_for
    from repro_torch.core import sweep as SW
    engine = engine or SW.SweepEngine()
    rows = []
    for m in store:
        if m.measured_bytes <= 0:
            continue
        policy = SW.POLICIES[m.policy]
        cfg, _, _ = engine._arch_state(m.arch, policy)
        ctx = _context_for(m, cfg)
        pred = engine.predict_cell(m.arch, policy, ctx, profile=profile,
                                   chip=m.chip, assembly=assembly)
        rows.append(ResidualRow(
            family=cfg.family,
            features=tuple(features_from(pred, ctx)),
            residual_gib=(m.measured_bytes - pred.peak_bytes) / GiB,
            measured_bytes=m.measured_bytes,
            calibrated_bytes=pred.peak_bytes))
    return rows


def _mape_of(rows, weights=None) -> float:
    if not rows:
        return 0.0
    if weights is None:
        return sum(r.ape_base for r in rows) / len(rows)
    return sum(r.ape_with(weights) for r in rows) / len(rows)


def _guarded_fit(rows, lam: float):
    """Ridge weights for ``rows``, or None when the fitted correction
    does not strictly improve the rows' own in-sample MAPE — the
    never-worsen guard: a model that cannot beat affine-only on the
    data it was fitted on must not ship.

    Rows are weighted by 1/measured: the solve minimizes the RELATIVE
    residual, which is the quantity every MAPE gate scores.  An
    unweighted GiB-scale least squares would chase the largest cells'
    absolute residuals and happily worsen small cells by whole
    percentage points."""
    import numpy as np

    from repro_torch.calibrate.fit import ridge
    A = np.array([r.features for r in rows], dtype=np.float64)
    b = np.array([r.residual_gib for r in rows], dtype=np.float64)
    wts = np.array([GiB / r.measured_bytes for r in rows],
                   dtype=np.float64)
    w = tuple(float(x) for x in ridge(A * wts[:, None], b * wts,
                                      lam=lam))
    if _mape_of(rows, w) < _mape_of(rows):
        return w
    return None


def fit_residual(store: MeasurementStore, profile=None, engine=None,
                 assembly: str = "legacy", lam: float = 1e-3,
                 created: str = "",
                 source: Optional[dict] = None) -> ResidualModel:
    """Fit a ResidualModel over a measurement store, on top of
    ``profile`` (None fits the residual of the RAW prediction).

    One guarded ridge solve per family with >= MIN_FAMILY_ROWS samples,
    plus the guarded global fallback over all rows.  Guard semantics
    (see ``_guarded_fit``) mean every emitted weight vector strictly
    improves the in-sample MAPE of the rows it will be applied to."""
    rows = residual_rows(store, profile=profile, engine=engine,
                         assembly=assembly)
    if not rows:
        raise ValueError(
            "cannot fit a residual model from zero usable measurements")
    by_family: dict[str, list] = {}
    for r in rows:
        by_family.setdefault(r.family, []).append(r)
    families = {}
    for fam, frows in sorted(by_family.items()):
        if len(frows) < MIN_FAMILY_ROWS:
            continue
        w = _guarded_fit(frows, lam)
        if w is not None:
            families[fam] = w
    gw = _guarded_fit(rows, lam)
    model = ResidualModel(
        families=families,
        global_weights=gw,
        base_profile_hash=profile_hash_of(profile),
        created=created,
        source=dict(source or {},
                    n_measurements=len(rows),
                    assembly=assembly,
                    families=sorted(by_family)),
        fit_info={"method": "ridge", "lam": lam,
                  "mape_affine_pct": round(_mape_of(rows), 4),
                  "mape_learned_pct": round(
                      _in_sample_mape(rows, families, gw), 4),
                  "skipped_families": sorted(
                      set(by_family) - set(families))})
    return model


def _in_sample_mape(rows, families: dict, gw) -> float:
    if not rows:
        return 0.0
    total = 0.0
    for r in rows:
        w = families.get(r.family, gw)
        total += r.ape_base if w is None else r.ape_with(w)
    return total / len(rows)


def leave_one_family_out(store: MeasurementStore):
    """Holdout folds: for each arch family in the store, (family,
    train_store, test_store) with every measurement of that family held
    out of the training split.  The held-out family exercises the
    model's GLOBAL fallback — exactly the generalization the BENCH
    calibration gate scores."""
    from repro_torch.calibrate.report import _family_of
    folds = []
    fams: dict[str, list] = {}
    for m in store:
        fams.setdefault(_family_of(m.arch), []).append(m)
    for fam in sorted(fams):
        train = MeasurementStore([m for f, ms in fams.items()
                                  if f != fam for m in ms])
        test = MeasurementStore(list(fams[fam]))
        folds.append((fam, train, test))
    return folds
