"""CalibrationProfile: per-term multiplicative corrections + chip offsets.

A profile is the output of ``repro_torch.calibrate.fit`` and the input of every
prediction path (``predictor.assemble``, ``planner.check/plan``, the sweep
engine): four non-negative coefficients, one per Eq.1 component group, plus
a per-chip-type constant overhead in bytes:

    peak_cal = c_static * (M_param + M_grad + M_opt + M_out_copy)
             + c_act_saved * M_act_saved
             + c_act_transient * M_act_transient
             + c_overhead * (M_loss + M_input + M_cache)
             + k_chip

Applied AFTER :func:`repro_torch.core.predictor.assemble` composes the raw
terms, so the cpu-oracle couplings inside ``act_transient`` (embed
all-gathers, the fp32 optimizer-update stacks) are scaled as one group —
exactly the granularity the residual decomposition fits.

Profiles are versioned JSON (see docs/calibration.md for the schema and
the staleness rules); ``profile_hash`` is a stable digest of everything
that changes a prediction, and participates in the sweep engine's memo
keys so cached cells can never leak across profiles.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

SCHEMA_VERSION = 1
PROFILE_KIND = "calibration_profile"

# The term groups a profile corrects — must track PredictedMemory's field
# groups; loading a profile fitted against a different term set fails
# (staleness rule 1 in docs/calibration.md).
TERMS = ("static", "act_saved", "act_transient", "overhead")

GiB = 1024 ** 3


@dataclass(frozen=True)
class CalibrationProfile:
    """Immutable, hashable correction profile (identity by default)."""

    coefficients: dict = field(
        default_factory=lambda: {t: 1.0 for t in TERMS})
    # chip type -> constant overhead bytes; "*" is the any-chip fallback
    chip_constant_bytes: dict = field(default_factory=dict)
    created: str = ""
    source: dict = field(default_factory=dict)
    fit_info: dict = field(default_factory=dict)

    def __post_init__(self):
        missing = [t for t in TERMS if t not in self.coefficients]
        if missing:
            raise ValueError(f"profile missing coefficients for {missing}")
        bad = [t for t, c in self.coefficients.items() if c < 0]
        if bad:
            raise ValueError(f"negative coefficients for {bad}")

    # -- identity ------------------------------------------------------------
    @classmethod
    def identity(cls) -> "CalibrationProfile":
        return cls()

    @property
    def is_identity(self) -> bool:
        return (all(self.coefficients[t] == 1.0 for t in TERMS)
                and not any(self.chip_constant_bytes.values()))

    # -- application ---------------------------------------------------------
    def coef(self, term: str) -> float:
        return float(self.coefficients[term])

    def chip_offset(self, chip: Optional[str]) -> int:
        if chip in self.chip_constant_bytes:
            return int(self.chip_constant_bytes[chip])
        return int(self.chip_constant_bytes.get("*", 0))

    def apply(self, pred, chip: Optional[str] = None):
        """Scaled copy of a PredictedMemory (duck-typed so core.predictor
        needs no import of this module).  ``per_module`` stays RAW — the
        breakdown documents where bytes come from, the calibrated totals
        are the per-term fields."""
        c_s = self.coef("static")
        scale = lambda v, c: int(round(v * c))
        return dataclasses.replace(
            pred,
            param_bytes=scale(pred.param_bytes, c_s),
            grad_bytes=scale(pred.grad_bytes, c_s),
            opt_bytes=scale(pred.opt_bytes, c_s),
            output_copy_bytes=scale(pred.output_copy_bytes, c_s),
            act_saved_bytes=scale(pred.act_saved_bytes,
                                  self.coef("act_saved")),
            act_transient_bytes=scale(pred.act_transient_bytes,
                                      self.coef("act_transient")),
            loss_bytes=scale(pred.loss_bytes, self.coef("overhead")),
            input_bytes=scale(pred.input_bytes, self.coef("overhead")),
            cache_bytes=scale(pred.cache_bytes, self.coef("overhead")),
            # serve terms: the KV pool is allocator overhead like the
            # contiguous cache it replaces; the draft model is extra
            # static residency (params + state), scaled accordingly
            pool_bytes=scale(pred.pool_bytes, self.coef("overhead")),
            hit_saved_bytes=scale(pred.hit_saved_bytes,
                                  self.coef("overhead")),
            draft_bytes=scale(pred.draft_bytes, c_s),
            calibration_bytes=self.chip_offset(chip))

    def scale_batch(self, values, term: str):
        """Vectorized affine twin of the per-field scaling in ``apply``:
        ``int(round(v * coef(term)))`` over an int64 array.  Same float64
        product, same round-half-even — the columnar sweep path
        (repro_torch.core.batch) stays byte-identical to per-cell application.
        """
        import numpy as np
        c = self.coef(term)
        return np.rint(np.asarray(values, np.float64) * c).astype(np.int64)

    # -- identity/serialization ---------------------------------------------
    def to_dict(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "kind": PROFILE_KIND,
            "terms": list(TERMS),
            "coefficients": {t: float(self.coefficients[t]) for t in TERMS},
            "chip_constant_bytes": {k: int(v) for k, v in sorted(
                self.chip_constant_bytes.items())},
            "created": self.created,
            "source": self.source,
            "fit": self.fit_info,
        }

    @property
    def profile_hash(self) -> str:
        """Digest of the prediction-changing payload ONLY (not metadata):
        two profiles that predict identically hash identically."""
        payload = {
            "schema_version": SCHEMA_VERSION,
            "coefficients": {t: float(self.coefficients[t]) for t in TERMS},
            "chip_constant_bytes": {k: int(v) for k, v in sorted(
                self.chip_constant_bytes.items())},
        }
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationProfile":
        if d.get("kind") != PROFILE_KIND:
            raise ValueError(
                f"not a calibration profile (kind={d.get('kind')!r})")
        if d.get("schema_version") != SCHEMA_VERSION:
            raise ValueError(
                f"profile schema_version {d.get('schema_version')!r} != "
                f"supported {SCHEMA_VERSION}; re-fit with "
                f"`python -m repro_torch.calibrate fit` (docs/calibration.md)")
        if tuple(d.get("terms", ())) != TERMS:
            raise ValueError(
                f"profile terms {d.get('terms')} do not match the current "
                f"predictor term set {list(TERMS)}; the profile is stale — "
                f"re-fit against fresh measurements")
        return cls(coefficients=dict(d["coefficients"]),
                   chip_constant_bytes=dict(
                       d.get("chip_constant_bytes", {})),
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
    def load(cls, path) -> "CalibrationProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def summary(self) -> str:
        cs = ", ".join(f"{t}={self.coefficients[t]:.4f}" for t in TERMS)
        ks = ", ".join(f"{k}={v / GiB:.3f}GiB" for k, v in sorted(
            self.chip_constant_bytes.items())) or "none"
        return (f"CalibrationProfile[{self.profile_hash}] {cs}; "
                f"chip offsets: {ks}")


def profile_hash_of(profile: Optional[CalibrationProfile]) -> Optional[str]:
    """Memo-key helper: None for the uncalibrated path."""
    return None if profile is None else profile.profile_hash
