"""Fit a CalibrationProfile from measurements via non-negative least
squares.

Model: for measurement i with raw term bytes t_{i,term} on chip c_i,

    measured_i  ~=  sum_term  coef_term * t_{i,term}  +  k_{c_i}

solved for non-negative ``coef_term`` (multiplicative per-term
corrections) and ``k_chip`` (per-chip-type constant overhead, bytes).
Columns are scaled to GiB before solving so term columns (1e9..1e12
bytes) and chip indicator columns condition comparably.

A term whose column is identically zero over the measurement set (e.g.
``overhead`` on a store with no serve cells AND no inputs) is left at the
identity coefficient 1.0 rather than the NNLS zero — a profile must never
silently erase a term it has no evidence about.

scipy's reference NNLS is used when available; otherwise a dependency-free
projected-gradient solve (FISTA-style) matches it to benchmark tolerance.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.calibrate.measurements import MeasurementStore
from repro_torch.calibrate.profile import TERMS, CalibrationProfile
from repro_torch.calibrate.residual import TermRow, decompose

GiB = 1024 ** 3


def nnls(A: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, float]:
    """min ||Ax - b||_2 s.t. x >= 0; (solution, residual norm)."""
    try:
        from scipy.optimize import nnls as _scipy_nnls
        x, rnorm = _scipy_nnls(A, b)
        return x, float(rnorm)
    except ImportError:
        return _pg_nnls(A, b)


def _pg_nnls(A: np.ndarray, b: np.ndarray,
             iters: int = 5000) -> tuple[np.ndarray, float]:
    """Projected-gradient fallback (no scipy): accelerated gradient on
    0.5||Ax-b||^2 with projection onto the non-negative orthant."""
    AtA = A.T @ A
    Atb = A.T @ b
    # Lipschitz constant of the gradient = largest eigenvalue of AtA
    L = float(np.linalg.eigvalsh(AtA)[-1]) or 1.0
    x = np.zeros(A.shape[1])
    y, t = x.copy(), 1.0
    for _ in range(iters):
        x_new = np.maximum(y - (AtA @ y - Atb) / L, 0.0)
        t_new = (1.0 + (1.0 + 4.0 * t * t) ** 0.5) / 2.0
        y = x_new + ((t - 1.0) / t_new) * (x_new - x)
        if np.max(np.abs(x_new - x)) < 1e-12:
            x = x_new
            break
        x, t = x_new, t_new
    return x, float(np.linalg.norm(A @ x - b))


def ridge(A: np.ndarray, b: np.ndarray,
          lam: float = 1e-3) -> np.ndarray:
    """Closed-form ridge regression: argmin ||Ax - b||^2 + lam ||x||^2.

    The solver behind the learned residual model
    (repro_torch.calibrate.learned): unlike the NNLS profile fit the residual
    weights are signed (a learned correction may subtract bytes), and
    the L2 penalty keeps small per-family sample sets from overfitting
    their noise.  ``lam > 0`` also makes the normal equations
    non-singular for constant/collinear feature columns."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = A.shape[1]
    return np.linalg.solve(A.T @ A + float(lam) * np.eye(n), A.T @ b)


def fit_rows(rows: list[TermRow], created: str = "",
             source: Optional[dict] = None) -> CalibrationProfile:
    """NNLS over pre-decomposed rows (see :func:`fit_profile`)."""
    if not rows:
        raise ValueError("cannot fit a profile from zero measurements")
    chips = sorted({r.measurement.chip for r in rows if r.measurement.chip})
    term_cols = np.array([[r.terms[t] / GiB for t in TERMS] for r in rows])
    chip_cols = np.array([[1.0 if r.measurement.chip == c else 0.0
                           for c in chips] for r in rows]) \
        if chips else np.zeros((len(rows), 0))
    b = np.array([r.measured_bytes / GiB for r in rows])

    # terms with no support in this measurement set stay at identity
    active = [j for j, t in enumerate(TERMS)
              if float(np.abs(term_cols[:, j]).sum()) > 0.0]
    A = np.hstack([term_cols[:, active], chip_cols])
    x, rnorm = nnls(A, b)

    coefficients = {t: 1.0 for t in TERMS}
    for k, j in enumerate(active):
        coefficients[TERMS[j]] = float(x[k])
    chip_constant = {c: int(round(float(x[len(active) + k]) * GiB))
                     for k, c in enumerate(chips)}
    return CalibrationProfile(
        coefficients=coefficients,
        chip_constant_bytes=chip_constant,
        created=created,
        source=dict(source or {},
                    n_measurements=len(rows),
                    archs=sorted({r.measurement.arch for r in rows}),
                    backends=sorted({r.measurement.backend for r in rows}),
                    chips=chips),
        fit_info={"method": "nnls", "residual_norm_gib": round(rnorm, 6),
                  "inactive_terms": [TERMS[j] for j in range(len(TERMS))
                                     if j not in active]})


def fit_profile(store: MeasurementStore, engine=None, created: str = "",
                source: Optional[dict] = None,
                assembly: str = "legacy") -> CalibrationProfile:
    """Decompose + fit in one call (the ``calibrate fit`` CLI backend)."""
    return fit_rows(decompose(store, engine, assembly=assembly),
                    created=created, source=source)
