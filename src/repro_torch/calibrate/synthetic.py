"""Deterministic synthetic measurements: the pipeline's CPU-only oracle.

Real measurement sources (runs on a device, the dry-run harness) are not
available on CPU-only CI, so this module manufactures a measurement set
with a KNOWN ground-truth distortion: it decomposes each cell's raw Eq.1
terms and re-composes them under a hidden "true" profile (per-term
multiplicative skews + per-chip constants) plus bounded deterministic
noise.  The fit must then recover the hidden profile from the residuals —
a closed-loop correctness check that needs no hardware.

Determinism is load-bearing: the bundled benchmark fixture
(benchmarks/fixtures/calibration_measurements.json) is regenerated and
compared in tests, so no wall-clock, no ``random`` — noise is derived
from a sha256 of the cell identity.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

from repro_torch.calibrate.measurements import Measurement, MeasurementStore
from repro_torch.calibrate.profile import TERMS, CalibrationProfile
from repro_torch.calibrate.residual import decompose

GiB = 1024 ** 3

# one arch per family, smallest member where the zoo offers a choice
SYNTHETIC_ARCHS: tuple[str, ...] = (
    "smollm-360m",             # dense
    "deepseek-v2-lite-16b",    # moe (MLA attention)
    "mamba2-1.3b",             # ssm
    "zamba2-2.7b",             # hybrid
    "llava15-7b",              # vlm (frozen vision tower)
    "seamless-m4t-large-v2",   # encdec
)

# The hidden allocator behavior the synthetic oracle applies to the
# liveness-at-peak terms: fragmentation and allocator rounding inflate
# saved activations, the analytic transient and overhead estimates are
# slightly conservative (real allocators reuse freed transient blocks),
# and each chip type carries a constant runtime/XLA reservation the
# analytic model does not see.  Against this oracle the raw legacy
# (sum-of-maxima) prediction lands at ~12.2% MAPE on the bundled
# fixture grid while the raw liveness peak lands at ~8.7% — the
# overlap slack is most of the gap the paper closes.
TRUE_PROFILE = CalibrationProfile(
    coefficients={"static": 0.99, "act_saved": 1.21,
                  "act_transient": 0.84, "overhead": 0.95},
    chip_constant_bytes={"v5e": int(0.14 * GiB), "h100": int(0.77 * GiB)},
    source={"note": "synthetic ground truth (repro_torch.calibrate.synthetic)"})

# Structure the affine profile CANNOT express — the signal the learned
# residual model (repro_torch.calibrate.learned) exists to recover:
#
# * FAMILY_ACT_SKEW — per-family multiplicative skew on the saved-
#   activation term (mean ~1.0 so the global NNLS coefficient stays
#   honest).  A single global ``act_saved`` coefficient averages over
#   these; only a per-family corrector can close them.
# * KNOB_EFFECTS — a family-INDEPENDENT additive reservation that grows
#   with log2(seq_len/1024) GiB (think allocator metadata / collective
#   buffers scaling with sequence).  No affine per-term coefficient or
#   per-chip constant can express a seq-dependent constant, but the
#   residual model's seq feature can — and because it is family-
#   independent it TRANSFERS to a family held out of the fit, which is
#   exactly what the leave-one-family-out benchmark gate scores.
FAMILY_ACT_SKEW: dict = {"dense": 1.06, "moe": 0.95, "ssm": 1.03,
                         "hybrid": 0.97, "vlm": 1.05, "encdec": 0.94}
KNOB_EFFECTS: dict = {"seq_gib_per_log2": 0.25}

DEFAULT_MESHES: tuple[dict, ...] = ({"data": 8, "model": 2},
                                    {"data": 4, "model": 4},
                                    {"data": 2, "model": 8})
DEFAULT_BATCHES: tuple[int, ...] = (16, 32)
# two seq_lens: act_saved scales ~linearly with seq but the transient's
# flash tiles / loss chunk do not — decorrelates the two columns
DEFAULT_SEQ_LENS: tuple[int, ...] = (1024, 2048)
DEFAULT_CHIPS: tuple[str, ...] = ("v5e", "h100")


def _unit_noise(key: str) -> float:
    """Deterministic value in [-1, 1) from the cell identity."""
    h = hashlib.sha256(key.encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 63 - 1.0


def generate(archs: Sequence[str] = SYNTHETIC_ARCHS,
             meshes: Sequence[dict] = DEFAULT_MESHES,
             global_batches: Sequence[int] = DEFAULT_BATCHES,
             seq_lens: Sequence[int] = DEFAULT_SEQ_LENS,
             chips: Sequence[str] = DEFAULT_CHIPS,
             backend: str = "tpu",
             noise: float = 0.01,
             true_profile: CalibrationProfile = TRUE_PROFILE,
             engine=None, assembly: str = "liveness",
             family_skew: Optional[dict] = FAMILY_ACT_SKEW,
             knob_effects: Optional[dict] = KNOB_EFFECTS
             ) -> MeasurementStore:
    """Synthesize measured_bytes for the (arch x mesh x batch x seq x chip)
    grid under ``true_profile`` with +-``noise`` relative deterministic
    jitter.

    The oracle composes from the ``assembly="liveness"`` interval-overlap
    decomposition by default: a real allocator frees the loss head before
    the backward transients materialize, so the true footprint follows
    the alloc/free overlap, not the legacy sum-of-maxima.  Against this
    oracle the raw legacy prediction carries a systematic overshoot (the
    overlap slack) on top of the skews — exactly the gap the liveness
    assembly closes.  Pass ``assembly="legacy"`` for the historical
    sum-of-maxima oracle.

    ``family_skew`` / ``knob_effects`` (defaults: the module constants)
    layer non-affine structure on top of the profile — the learned
    residual model's ground truth.  Pass ``None`` for either to get a
    PURE affine oracle (the profile-recovery tests do: an exact NNLS
    inversion is only defined against an exactly-affine truth)."""
    import math

    from repro_torch.core import sweep as SW
    from repro_torch.configs import get_config
    engine = engine or SW.SweepEngine()
    cells = MeasurementStore()
    for arch in archs:
        arch = SW.normalize_arch(arch)
        for chip in chips:
            for mesh in meshes:
                for gb in global_batches:
                    for seq in seq_lens:
                        cells.add(Measurement(
                            arch=arch, kind="train", seq_len=int(seq),
                            global_batch=int(gb), mesh_shape=dict(mesh),
                            measured_bytes=0, backend=backend, chip=chip,
                            source="synthetic"))
    for row in decompose(cells, engine, assembly=assembly):
        m = row.measurement
        skew = (family_skew or {}).get(get_config(m.arch).family, 1.0)
        true_bytes = sum(true_profile.coef(t) * row.terms[t]
                         * (skew if t == "act_saved" else 1.0)
                         for t in TERMS)
        true_bytes += true_profile.chip_offset(m.chip)
        if knob_effects:
            true_bytes += (knob_effects.get("seq_gib_per_log2", 0.0)
                           * math.log2(max(m.seq_len, 1) / 1024) * GiB)
        jitter = 1.0 + noise * _unit_noise("|".join(map(str, m.key)))
        m.measured_bytes = int(round(true_bytes * jitter))
        m.meta = {"noise": noise,
                  "true_profile": true_profile.profile_hash,
                  "family_skew": bool(family_skew),
                  "knob_effects": bool(knob_effects)}
    return cells
