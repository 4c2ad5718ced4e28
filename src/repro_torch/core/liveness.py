"""Liveness assembly: interval-overlap peak from an alloc/free event program.

Eq.1's legacy assembly adds every component's own maximum — saved
activations, the worst transient block, the loss head, the optimizer-update
stacks — as if all of them were resident at once.  On a real step they are
not: the loss head fires after the forward stash is full but before the
backward transient exists, and the optimizer update runs only after the
backward has freed the stash.  The dynamic-analysis line of related work
(arXiv:2504.03887; xMem) reports that exactly this buffer-lifetime overlap,
not per-layer math, dominates estimator error.

This module compiles the step schedule — parse table + ``stages.py``
partition + microbatch stash rules — into a **cell-independent** alloc/free
event program.  Events carry ±1 coefficients over named *components* whose
byte values are the existing Eq.1 factors (every one of them evaluated from
the same TermSpecs the legacy path uses — no new env tokens), so the scalar
replay here and the columnar contraction in ``core.batch`` share one source
of truth.  The peak is the maximum running-sum prefix over the program:

    peak_liveness = max_j  sum_{i<=j} delta_i . values

which the columnar engines compute as a segmented cummax over the event
axis.  Because every event delta is a ±1 combination of non-negative
component values, every prefix is a sub-sum of the legacy total — hence
``peak_liveness <= peak_legacy`` always, which is what keeps the
branch-and-bound statics floor and the aligned batch ladder sound
(docs/search.md).

Microbatch handling: the 1F1B warmup ramp fills the stash one microbatch at
a time, but the running sum is maximal only once the stash is full — so the
ramp collapses to a single ``+saved`` event whose value already carries the
``stash_count`` multiplier (exactly the value the legacy path uses).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

ASSEMBLIES = ("legacy", "liveness")

# Component vocabulary.  Values come from the predictor's component groups
# (StaticTerms / ActTermsAgg / OverheadTerms) — see values_of() callers in
# core.predictor and the column tables in core.batch.
COMPONENTS = (
    "base",           # params + grads + opt states (+ chip constant when
                      # calibrated): persistent for the whole step
    "inputs",         # batch arguments (first stage)
    "cache",          # fixed (non-paged) serve caches
    "pool",           # paged KV pool (serve)
    "draft",          # speculative-draft residency (serve, first stage)
    "embed",          # all-gathered embedding tables (fwd lookup + bwd
                      # scatter at train; lookup only at serve)
    "saved",          # saved-for-backward set x stash_count
    "boundary",       # pipeline stage-boundary send/recv buffers
    "loss",           # loss-head / logits window (last stage)
    "transient",      # one block's recomputed-backward (train) or forward
                      # (serve) working set
    "opt_transient",  # optimizer-update in-flight fp32 stacks
    "out_copy",       # non-aliased updated-param copy of the train step
)

# Profile term group of each component — mirrors CalibrationProfile.apply
# and calibrate.residual.decompose exactly.
COMPONENT_TERM = {
    "base": "static", "out_copy": "static", "draft": "static",
    "saved": "act_saved",
    "embed": "act_transient", "boundary": "act_transient",
    "transient": "act_transient", "opt_transient": "act_transient",
    "inputs": "overhead", "cache": "overhead", "loss": "overhead",
    "pool": "overhead",
}

# Canonical telescoping order of the act_transient group (see
# telescoped_transient): the legacy path scales e+b+t+o as ONE group, so
# the liveness deltas must be differences of cumulative scaled prefixes in
# a fixed order to sum back to the legacy group byte-exactly.
TRANSIENT_ORDER = ("embed", "boundary", "transient", "opt_transient")


@dataclass(frozen=True)
class Event:
    """One schedule point: a set of ±1 component deltas."""

    label: str
    deltas: tuple  # ((component, +1 | -1), ...)


@dataclass(frozen=True)
class EventProgram:
    """Cell-independent alloc/free program for one step kind."""

    kind: str
    events: tuple  # (Event, ...)

    @property
    def n_events(self) -> int:
        return len(self.events)

    def delta_matrix(self) -> list:
        """``n_events x len(COMPONENTS)`` list-of-lists of {-1, 0, +1}
        coefficients in COMPONENTS order — the contraction matrix the
        columnar engines multiply against component columns."""
        idx = {c: i for i, c in enumerate(COMPONENTS)}
        rows = []
        for ev in self.events:
            row = [0] * len(COMPONENTS)
            for comp, sign in ev.deltas:
                row[idx[comp]] += sign
            rows.append(row)
        return rows

    def net_deltas(self) -> dict:
        """Component -> net coefficient over the whole program.  Persistent
        components net +1 (allocated, never freed within the step); every
        within-step buffer nets 0 (each alloc has a matching free)."""
        net = {c: 0 for c in COMPONENTS}
        for ev in self.events:
            for comp, sign in ev.deltas:
                net[comp] += sign
        return net


# Persistent components: allocated by the first event, freed outside the
# step window — the running sum must return to exactly their sum.
_PERSISTENT = ("base", "cache", "pool", "draft")

_TRAIN_EVENTS = (
    Event("persist", (("base", +1), ("cache", +1), ("pool", +1),
                      ("draft", +1))),
    Event("step_in", (("inputs", +1),)),
    # the token-lookup all-gather materializes at the first forward and its
    # gradient scatter-add lives until the last backward -> spans the step
    Event("fwd_embed", (("embed", +1),)),
    # forward fills the stash (warmup ramp collapsed — see module docstring)
    # while the steady-state boundary send/recv buffers are in flight
    Event("fwd_stash", (("saved", +1), ("boundary", +1))),
    # loss head on the last stage: hidden + logits chunk, freed before the
    # body's backward starts recomputing
    Event("loss_head", (("loss", +1),)),
    Event("loss_free", (("loss", -1),)),
    # backward walks the scan: one block's recomputed working set is live
    # against the still-full stash
    Event("bwd_recompute", (("transient", +1),)),
    Event("bwd_free", (("transient", -1), ("saved", -1), ("boundary", -1),
                       ("embed", -1))),
    # optimizer update: in-flight fp32 stacks + the non-aliased updated
    # params, after the backward freed the activation set
    Event("opt_update", (("opt_transient", +1), ("out_copy", +1))),
    Event("step_out", (("opt_transient", -1), ("out_copy", -1),
                       ("inputs", -1))),
)

# Serve kinds (prefill / decode / paged variants): no backward, no
# optimizer — the embed gather, the block transient and the logits head are
# exclusive windows over a persistent cache+carry floor.
_SERVE_EVENTS = (
    Event("persist", (("base", +1), ("cache", +1), ("pool", +1),
                      ("draft", +1))),
    Event("step_in", (("inputs", +1),)),
    Event("fwd_carry", (("saved", +1), ("boundary", +1))),
    Event("embed_gather", (("embed", +1),)),
    Event("embed_free", (("embed", -1),)),
    Event("block_transient", (("transient", +1),)),
    Event("block_free", (("transient", -1),)),
    Event("logits_head", (("loss", +1),)),
    Event("logits_free", (("loss", -1),)),
    Event("step_out", (("saved", -1), ("boundary", -1), ("inputs", -1))),
)


@functools.lru_cache(maxsize=8)
def compile_program(kind: str) -> EventProgram:
    """Event program for a step kind.  Stage/schedule specifics (stash
    multiplier, boundary edge count, loss-on-last / inputs-on-first) enter
    through component VALUES, not program shape — the program itself is
    cell-independent, which is what lets the columnar engines contract one
    delta matrix against whole knob columns."""
    events = _TRAIN_EVENTS if kind == "train" else _SERVE_EVENTS
    program = EventProgram(kind=kind, events=events)
    _validate(program)
    return program


def _validate(program: EventProgram) -> None:
    """Ledger conservation: every within-step alloc has a matching free and
    persistent components are allocated exactly once (net +1)."""
    for comp, net in program.net_deltas().items():
        want = 1 if comp in _PERSISTENT else 0
        if net != want:
            raise AssertionError(
                f"{program.kind}: component {comp!r} nets {net}, "
                f"expected {want}")


@dataclass(frozen=True)
class Replay:
    """Scalar replay result (the columnar engines' parity oracle)."""

    peak: int                 # max running-sum prefix
    event_index: int          # first prefix attaining the peak
    event_label: str
    prefixes: tuple           # running sum after every event
    final: int                # running sum after the last event
    group_at_peak: dict       # profile term -> live bytes at the peak


def replay(program: EventProgram, values: dict) -> Replay:
    """Replay the program against component byte values (missing components
    default to 0; all values must be >= 0).  Ties keep the earliest event,
    mirroring the strictly-greater stage rule in ``predictor.predict``."""
    for comp, v in values.items():
        if comp not in COMPONENT_TERM:
            raise ValueError(f"unknown component {comp!r}")
        if v < 0:
            raise ValueError(f"negative component {comp}={v}")
    run = 0
    live = {c: 0 for c in COMPONENTS}
    prefixes = []
    peak, peak_i, peak_live = 0, 0, dict(live)
    for i, ev in enumerate(program.events):
        for comp, sign in ev.deltas:
            run += sign * values.get(comp, 0)
            live[comp] += sign
        prefixes.append(run)
        if run > peak or i == 0:
            peak, peak_i, peak_live = run, i, dict(live)
    groups = {t: 0 for t in ("static", "act_saved", "act_transient",
                             "overhead")}
    for comp, n in peak_live.items():
        if n:
            groups[COMPONENT_TERM[comp]] += n * values.get(comp, 0)
    return Replay(peak=peak, event_index=peak_i,
                  event_label=program.events[peak_i].label,
                  prefixes=tuple(prefixes), final=run,
                  group_at_peak=groups)


def telescoped_transient(values: dict, scale) -> dict:
    """Calibrated deltas of the act_transient group.

    The legacy path scales ``embed + boundary + transient + opt_transient``
    as ONE group: ``scale(e + b + t + o)``.  The liveness program needs the
    four members separately, so each scaled delta is the difference of
    cumulative scaled prefixes in TRANSIENT_ORDER:

        d_embed     = scale(e)
        d_boundary  = scale(e + b)         - scale(e)
        d_transient = scale(e + b + t)     - scale(e + b)
        d_opt       = scale(e + b + t + o) - scale(e + b + t)

    ``scale`` must be monotone with scale(0) == 0 (both the scalar
    ``int(round(v * c))`` and the vectorized ``np.rint`` twin are, for
    c >= 0), so every delta is >= 0 and their sum telescopes back to the
    legacy group scale EXACTLY — which is what guarantees calibrated
    liveness <= calibrated legacy in integer arithmetic.
    """
    out = {}
    run = 0
    prev = scale(0)
    for name in TRANSIENT_ORDER:
        run += values.get(name, 0)
        cur = scale(run)
        out[name] = cur - prev
        prev = cur
    return out
