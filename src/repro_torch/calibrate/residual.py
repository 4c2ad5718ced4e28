"""Residual decomposition: one design-matrix row per measurement.

For every measurement the UNCALIBRATED Eq.1 components are recomputed
through the exact predictor component functions the sweep engine memoizes
(``compute_static`` / ``compute_acts`` / ``compute_overheads`` composed by
``assemble``), then grouped into the profile's term set:

    static        = M_param + M_grad + M_opt + M_out_copy
    act_saved     = M_act_saved
    act_transient = M_act_transient (incl. embed gathers + opt-update stacks)
    overhead      = M_loss + M_input + M_cache

The residual ``measured - raw_peak`` is what the NNLS fit re-attributes
per term; going through the shared :class:`repro_torch.core.sweep.SweepEngine`
means decomposing N measurements costs one model build per architecture.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.calibrate.measurements import Measurement, MeasurementStore
from repro_torch.calibrate.profile import TERMS


@dataclass(frozen=True)
class TermRow:
    """Raw per-term bytes + measured total for one cell."""

    measurement: Measurement
    terms: dict                    # term name -> raw bytes
    raw_peak_bytes: int

    @property
    def measured_bytes(self) -> int:
        return self.measurement.measured_bytes

    @property
    def residual_bytes(self) -> int:
        return self.measurement.measured_bytes - self.raw_peak_bytes


def _context_for(m: Measurement, cfg):
    """Rebuild the EXACT cell the measurement was taken on.  Every knob
    the Measurement carries must reach make_context — dropping
    microbatches/schedule/offload here would decompose a pipelined or
    offloaded measurement against the wrong cell (m=1, no offload) and
    poison every profile fitted from it."""
    from repro_torch.core import planner as PL
    return PL.make_context(cfg, m.mesh_shape, kind=m.kind,
                           global_batch=m.global_batch, seq_len=m.seq_len,
                           backend=m.backend, grad_accum=m.grad_accum,
                           remat=m.remat, optimizer=m.optimizer,
                           microbatches=m.microbatches,
                           schedule=m.schedule,
                           offload_opt=m.offload_optimizer)


def predict_measurement(m: Measurement, engine=None, profile=None,
                        assembly: str = "legacy", residual=None):
    """The framework's prediction for a measured cell (optionally
    calibrated and residual-corrected), through the shared memoized
    engine."""
    from repro_torch.core import sweep as SW
    engine = engine or SW.SweepEngine()
    policy = SW.POLICIES[m.policy]
    cfg, _, _ = engine._arch_state(m.arch, policy)
    ctx = _context_for(m, cfg)
    return engine.predict_cell(m.arch, policy, ctx, profile=profile,
                               chip=m.chip, assembly=assembly,
                               residual=residual)


def decompose(store: MeasurementStore, engine=None,
              assembly: str = "legacy") -> list[TermRow]:
    """Raw term groups for every measurement (shared engine caches).

    ``assembly="liveness"`` decomposes the interval-overlap peak
    instead: the per-term bytes are the components LIVE at the winning
    event of the alloc/free program (``liveness.Replay.group_at_peak``),
    so the rows still sum to that assembly's raw peak exactly and the
    NNLS fit calibrates the composed liveness peak through the same
    affine transform.
    """
    from repro_torch.core import sweep as SW
    engine = engine or SW.SweepEngine()
    rows = []
    for m in store:
        pred = predict_measurement(m, engine, assembly=assembly)
        if assembly == "liveness":
            terms = dict(pred.liveness_groups)
        else:
            terms = {
                "static": (pred.param_bytes + pred.grad_bytes
                           + pred.opt_bytes + pred.output_copy_bytes),
                "act_saved": pred.act_saved_bytes,
                "act_transient": pred.act_transient_bytes,
                "overhead": (pred.loss_bytes + pred.input_bytes
                             + pred.cache_bytes),
            }
        assert set(terms) == set(TERMS)
        assert sum(terms.values()) == pred.peak_bytes
        rows.append(TermRow(measurement=m, terms=terms,
                            raw_peak_bytes=pred.peak_bytes))
    return rows
