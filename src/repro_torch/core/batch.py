"""Columnar batch evaluation of the Eq.1 memory model.

The per-cell path (``SweepEngine.evaluate`` -> ``predictor.assemble``)
costs tens of microseconds of Python per cell; a real pre-launch capacity
search covers 10^5-10^6 cells (every mesh factorization x remat x
optimizer x schedule x microbatches x grad-accum x batch x seq-len x chip
type), where interpreter overhead — not arithmetic — is the bound.  This
module lowers the predictor's component groups into structure-of-arrays
NumPy kernels that evaluate ALL cells of a
:class:`repro_torch.core.sweep.SweepGrid` at once:

* per-layer byte terms are factored into (arch-dependent,
  cell-independent) :class:`repro_torch.core.factors.TermSpec` coefficient
  tuples built once per arch x policy x pipeline stage — the SAME specs
  the scalar path evaluates, so the two paths share one source of truth;
* cell-dependent knobs (micro-batch, seq-len, encoder len, loss/flash
  chunks, pipeline microbatches) become int64 column arrays over the
  grid's unique knob tuples, contracted against the specs in
  ``O(stages x layers x cells)`` array ops;
* mesh shard counts come from :func:`batch_shard_factor`, an exact
  broadcast transliteration of ``mesh_ctx.assign_axes`` — divisibility,
  axis-reuse, FSDP/ZeRO greedy assignment and the pipe-axis exclusion
  are computed per cell with boolean masks, in integer arithmetic; the
  expert-parallel (`expert`) and context-parallel (`context`) axes flow
  through the same rule machinery, with the MoE-only (`experts` /
  `expert_buf`) and attention-only (ring KV block, gated per mesh on
  cp > 1) terms columnar-gated exactly like the scalar path;
* pipeline parallelism groups meshes by their ``pipe`` degree: every
  mesh in a group shares one stage partition (``core.stages``), the
  per-stage tables compose exactly like the scalar per-stage
  ``assemble``, the schedule's in-flight stash scales the saved-act
  column, and the cell's peak is the elementwise max over stages;
* :class:`~repro_torch.calibrate.profile.CalibrationProfile` application
  is a vectorized affine transform per stage (one multiply + round per
  term group), maxed over stages like the scalar path.

Everything is exact int64 + floor-division arithmetic (float enters only
where the scalar path itself uses floats: the calibration coefficients
and the optimizer-transient fraction, reproduced operation-for-operation)
so the columnar path is BYTE-IDENTICAL to per-cell ``planner.check`` —
asserted against the reference package in tests/test_torch_sweep.py and
tests/test_torch_predictor.py.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core import factors as F
from repro_torch.core import planner as PL
from repro_torch.core import predictor as PR
from repro_torch.core import sweep as SW
from repro_torch.core.spec import FULL_TRAIN, dtype_bytes
from repro_torch.mesh_ctx import CONTEXT_AXIS, PIPE_AXIS

I64 = np.int64

# Optional shard-factor implementation, installed for a table build by
# ``repro_torch.kernels.shard_factor.resolve_batched`` (which records the
# build's requests, then answers them from one batched launch) — None
# means the numpy path below runs.
_shard_factor_impl = None

# Optional accelerated segmented-cummax twin for the liveness assembly
# (the CUDA kernel over the event axis), installed by
# ``repro_torch.kernels.segmented_cummax.use_backend`` — None means the
# numpy path in ``liveness_peak_batch`` runs.
_liveness_peak_impl = None


def liveness_peak_batch(deltas: np.ndarray) -> np.ndarray:
    """Per-cell interval-overlap peak of an event-delta stack.

    ``deltas`` is ``(n_events, n_cells)`` int64 — each row the contraction
    of one event's ±1 component coefficients (``core.liveness``) against
    the component columns.  The peak is the max over running event-axis
    prefix sums (a segmented cummax: cumsum along events, max-reduce),
    exactly ``liveness.replay``'s ``max(prefixes)`` per cell."""
    if _liveness_peak_impl is not None:
        return np.asarray(_liveness_peak_impl(deltas), I64)
    return np.cumsum(deltas, axis=0).max(axis=0)


def _liveness_deltas(kind: str, comps: dict, m: int) -> np.ndarray:
    """Event-delta stack for one pipeline stage: program delta matrix
    (cell-independent) contracted against the stage's component columns
    (missing / None components contribute 0, mirroring replay())."""
    from repro_torch.core import liveness as LV
    prog = LV.compile_program(kind)
    deltas = np.zeros((prog.n_events, m), I64)
    for ei, row in enumerate(prog.delta_matrix()):
        for ci, coef in enumerate(row):
            if coef:
                col = comps.get(LV.COMPONENTS[ci])
                if col is not None:
                    deltas[ei] += coef * np.asarray(col, I64)
    return deltas


# ---------------------------------------------------------------------------
# vectorized shard resolution
# ---------------------------------------------------------------------------


def batch_shard_factor(dims, axes, sizes: dict, rules: dict,
                       extra=()) -> np.ndarray:
    """Exact broadcast twin of :func:`repro_torch.mesh_ctx.shard_factor`.

    ``dims`` entries and ``sizes`` values may be ints or broadcastable
    int64 arrays; the result has the full broadcast shape.  The greedy
    axis assignment of ``mesh_ctx.assign_axes`` (divisibility checks,
    one-use-per-axis, FSDP/ZeRO ``extra`` pass, the ``layers`` stack-dim
    exclusion, the never-shard ``pipe`` axis) is transliterated with
    per-cell boolean masks.

    Mesh axes absent from a given mesh may be supplied as size-1 entries:
    a size-1 axis multiplies every factor by 1 and never changes another
    axis's divisibility, so the result equals the scalar path's
    skip-missing behaviour.
    """
    if _shard_factor_impl is not None:
        return _shard_factor_impl(dims, axes, sizes, rules, extra)
    arrs = [np.asarray(d, I64) for d in dims]
    svals = {a: np.asarray(v, I64) for a, v in sizes.items()}
    shape = np.broadcast_shapes(*(a.shape for a in arrs),
                                *(v.shape for v in svals.values()))
    # a size-1 axis multiplies every factor by 1 and can never block a
    # later dim (marking it "used" only matters to another x1 attempt),
    # so all-ones columns — e.g. the expert/context padding of meshes
    # without those axes — are skipped outright
    live = {a for a, v in svals.items() if np.any(v > 1)}
    one = np.ones((), I64)
    totals = [one] * len(arrs)         # per-dim applied shard product
    denom = one
    used: dict[str, np.ndarray] = {}
    for i, ax in enumerate(axes):
        if not ax:
            continue
        for a in rules.get(ax, ()):
            if a == PIPE_AXIS or a not in live:
                continue
            ok = arrs[i] % (totals[i] * svals[a]) == 0
            prev = used.get(a)
            if prev is not None:
                ok = ok & ~prev
            totals[i] = np.where(ok, totals[i] * svals[a], totals[i])
            denom = np.where(ok, denom * svals[a], denom)
            used[a] = ok if prev is None else (prev | ok)
    for a in extra:
        if a == PIPE_AXIS or a not in live:
            continue
        prev = used.get(a)
        avail = ~prev if prev is not None else np.ones((), bool)
        assigned = np.zeros((), bool)
        for i in range(len(arrs)):
            # never FSDP/ZeRO-shard the scan-stack dim (see mesh_ctx)
            if axes[i] == "layers":
                continue
            ok = avail & ~assigned \
                & (arrs[i] % (totals[i] * svals[a]) == 0)
            totals[i] = np.where(ok, totals[i] * svals[a], totals[i])
            denom = np.where(ok, denom * svals[a], denom)
            assigned = assigned | ok
        used[a] = assigned if prev is None else (prev | assigned)
    return np.broadcast_to(denom, shape)


def eval_term_batch(spec: F.TermSpec, env: dict, sizes: dict,
                    rules: dict) -> np.ndarray:
    """Batch twin of :func:`repro_torch.core.factors.eval_term`: same
    ``mult * prod(dims) * nbytes // max(denom, 1)`` integer arithmetic,
    broadcast over the knob columns in ``env`` and the mesh ``sizes``."""
    dims = tuple(env[d] if isinstance(d, str) else d for d in spec.dims)
    denom = batch_shard_factor(dims, spec.axes, sizes, rules)
    q = np.asarray(spec.mult * spec.nbytes, I64)
    for d in dims:
        q = q * np.asarray(d, I64)
    return q // np.maximum(denom, 1)


# ---------------------------------------------------------------------------
# grid -> column arrays
# ---------------------------------------------------------------------------


@dataclass
class CellColumns:
    """Structure-of-arrays twin of ``SweepGrid.cells()``: the exact same
    cells in the exact same order, as int64 code columns into the small
    per-axis value tables instead of one SweepCell object per cell."""

    n: int
    arches: tuple
    chips: tuple
    meshes: tuple                   # of dict
    opts: tuple                     # raw (may contain None)
    offs: tuple                     # offload-optimizer knob values (bool)
    remats: tuple                   # raw (may contain None)
    scheds: tuple                   # pipeline schedules ("1f1b"/"gpipe")
    mbs: tuple                      # pipeline microbatch counts
    serves: tuple                   # Optional[ServeSpec] per combo
    pairs: tuple                    # (grad_accum, global_batch), enum order
    seqs: tuple
    kind: str
    backend: str
    # per-cell code columns (int64)
    arch_c: np.ndarray
    chip_c: np.ndarray
    mesh_c: np.ndarray
    opt_c: np.ndarray
    off_c: np.ndarray
    remat_c: np.ndarray
    sched_c: np.ndarray
    mb_c: np.ndarray
    srv_c: np.ndarray
    pair_c: np.ndarray
    seq_c: np.ndarray
    # per-cell knob values (int64)
    accum: np.ndarray
    gb: np.ndarray
    seq: np.ndarray
    micro: np.ndarray


def build_columns(grid: "SW.SweepGrid") -> CellColumns:
    """Lower a grid to code columns.  Mirrors ``SweepGrid.cells()``:
    arch -> chip -> mesh -> optimizer -> offload -> remat -> schedule ->
    microbatch -> serve -> accum -> batch -> seq, innermost fastest, with
    non-divisible (batch, accum) pairs dropped."""
    arches = tuple(SW.normalize_arch(a) for a in SW._seq(grid.arch))
    chips = tuple(SW._seq(grid.chip))
    meshes = tuple(grid.meshes())
    opts = tuple(SW._seq(grid.optimizers))
    offs = tuple(grid.offloads())
    remats = tuple(SW._seq(grid.remats))
    scheds = tuple(grid.check_schedules())
    mbs = tuple(int(m) for m in SW._seq(grid.microbatches))
    serves = tuple(grid.serve_specs())
    pairs = tuple((int(a), int(g)) for a in SW._seq(grid.grad_accums)
                  for g in SW._seq(grid.global_batches) if not g % a)
    seqs = tuple(int(s) for s in SW._seq(grid.seq_lens))

    sizes = [len(arches), len(chips), len(meshes), len(opts), len(offs),
             len(remats), len(scheds), len(mbs), len(serves), len(pairs),
             len(seqs)]
    n = math.prod(sizes)
    if n == 0:
        z = np.zeros(0, I64)
        return CellColumns(0, arches, chips, meshes, opts, offs, remats,
                           scheds, mbs, serves, pairs, seqs, grid.kind,
                           grid.backend,
                           z, z, z, z, z, z, z, z, z, z, z, z, z, z, z)
    # code column i cycles 0..s_i-1 with period inner_i (the product of
    # the axes to its right): repeat+tile is a pair of memcpy-shaped ops
    # instead of the old idx%s / idx//=s passes over the full column
    codes = []
    inner = 1
    for s in reversed(sizes):
        if s == 1:
            codes.append(np.zeros(n, I64))
        else:
            codes.append(np.tile(np.repeat(np.arange(s, dtype=I64), inner),
                                 n // (s * inner)))
        inner *= s
    (seq_c, pair_c, srv_c, mb_c, sched_c, remat_c, off_c, opt_c, mesh_c,
     chip_c, arch_c) = codes
    accum = np.array([p[0] for p in pairs], I64)[pair_c]
    gb = np.array([p[1] for p in pairs], I64)[pair_c]
    seq = np.array(seqs, I64)[seq_c]
    micro = np.array(mbs, I64)[mb_c]
    return CellColumns(n, arches, chips, meshes, opts, offs, remats,
                       scheds, mbs, serves, pairs, seqs, grid.kind,
                       grid.backend,
                       arch_c, chip_c, mesh_c, opt_c, off_c, remat_c,
                       sched_c, mb_c, srv_c, pair_c, seq_c, accum, gb,
                       seq, micro)


# ---------------------------------------------------------------------------
# lazy result store
# ---------------------------------------------------------------------------


@dataclass
class ColumnarResults:
    """Array-backed sweep verdicts; ``result(i)`` materializes one
    :class:`~repro_torch.core.sweep.SweepResult` identical to the cell path's."""

    n: int
    kind: str
    backend: str
    arch_names: tuple
    chip_names: tuple
    meshes: tuple                    # of dict
    n_chips_by_mesh: np.ndarray
    opt_names: tuple                 # resolved (never None)
    remat_names: tuple               # resolved
    sched_names: tuple
    arch_c: np.ndarray
    chip_c: np.ndarray
    mesh_c: np.ndarray
    opt_c: np.ndarray                # codes into opt_names
    remat_c: np.ndarray              # codes into remat_names
    sched_c: np.ndarray              # codes into sched_names
    microbatches: np.ndarray
    grad_accum: np.ndarray
    global_batch: np.ndarray
    seq_len: np.ndarray
    peak_bytes: np.ndarray
    budget_bytes: np.ndarray
    fits: np.ndarray                 # bool
    # serving-fleet axis + peak-stage serve provenance (all-zero /
    # single-None on grids without active serve knobs)
    serves: tuple = (None,)
    srv_c: Optional[np.ndarray] = None
    pool_bytes: Optional[np.ndarray] = None
    draft_bytes: Optional[np.ndarray] = None
    hit_saved_bytes: Optional[np.ndarray] = None
    # Eq.1 offload-tier axis + peak-stage host-optimizer provenance
    offs: tuple = (False,)
    off_c: Optional[np.ndarray] = None
    offload_bytes: Optional[np.ndarray] = None
    # liveness assembly: winning stage's legacy - liveness overestimate
    # (None on legacy-assembly runs — zero extra work there)
    overlap_slack_bytes: Optional[np.ndarray] = None

    @property
    def n_chips(self) -> np.ndarray:
        return self.n_chips_by_mesh[self.mesh_c]

    def result(self, i: int) -> "SW.SweepResult":
        return SW.SweepResult(
            arch=self.arch_names[self.arch_c[i]],
            chip=self.chip_names[self.chip_c[i]],
            mesh_shape=dict(self.meshes[self.mesh_c[i]]),
            n_chips=int(self.n_chips_by_mesh[self.mesh_c[i]]),
            optimizer=self.opt_names[self.opt_c[i]],
            remat=self.remat_names[self.remat_c[i]],
            schedule=self.sched_names[self.sched_c[i]],
            microbatches=int(self.microbatches[i]),
            grad_accum=int(self.grad_accum[i]),
            global_batch=int(self.global_batch[i]),
            seq_len=int(self.seq_len[i]),
            kind=self.kind, backend=self.backend,
            serve=None if self.srv_c is None
            else self.serves[self.srv_c[i]],
            pool_bytes=0 if self.pool_bytes is None
            else int(self.pool_bytes[i]),
            draft_bytes=0 if self.draft_bytes is None
            else int(self.draft_bytes[i]),
            hit_saved_bytes=0 if self.hit_saved_bytes is None
            else int(self.hit_saved_bytes[i]),
            offload=False if self.off_c is None
            else bool(self.offs[self.off_c[i]]),
            offload_bytes=0 if self.offload_bytes is None
            else int(self.offload_bytes[i]),
            overlap_slack_bytes=0 if self.overlap_slack_bytes is None
            else int(self.overlap_slack_bytes[i]),
            peak_bytes=int(self.peak_bytes[i]),
            budget_bytes=int(self.budget_bytes[i]),
            fits=bool(self.fits[i]), prediction=None)

# ---------------------------------------------------------------------------
# per-arch / per-stage component tables
# ---------------------------------------------------------------------------


def _act_entries(row) -> list:
    """(name, ActTerm) entries with the exact dict semantics of
    ``factors.layer_act_terms`` (keyed by name, last value wins, first
    insertion order)."""
    d = {}
    for t in row.layer.acts:
        d[t.name] = t
    return list(d.items())


_DIM_TOKENS = {"B": "mb", "S": "seq", "T": "enc"}


def _sym_dims(term) -> tuple:
    """ActTerm shape -> TermSpec-style symbolic dims."""
    return tuple(_DIM_TOKENS[d] if isinstance(d, str) else int(d)
                 for d in term.shape)


def _resolve_dims(dims, env) -> tuple:
    return tuple(env[d] if isinstance(d, str) else d for d in dims)


def _dims_prod(dims) -> np.ndarray:
    q = np.asarray(1, I64)
    for d in dims:
        q = q * np.asarray(d, I64)
    return q


def _knob_env(cfg, cols: CellColumns, pp: int) -> dict:
    """Int64 knob columns over the grid's unique
    (microbatches, accum, batch, seq) tuples for one pipeline degree —
    the batch twin of ``factors.term_env`` (whose ``mb`` is the pipeline
    micro-batch) plus the derived columns the composition needs.

    Microbatches only split the batch when there is a pipeline to fill
    (``PredictContext.eff_microbatches``); pp==1 / serve groups collapse
    the microbatch axis entirely (``_expanded`` False) so their tables
    are not built ``len(microbatches)`` times over identical columns —
    the caller indexes them with the reduced (pair, seq) code.

    On serve kinds with any active serving-fleet spec the T axis expands
    over (serve, pair, seq) instead — mutually exclusive with the train
    microbatch expansion, because ``planner.check_serve`` rejects active
    serve knobs on train kinds up front — and the env grows the paged-KV
    ``pool_tok`` column (plus its hit-rate-0 twin for the hit-savings
    delta), computed per (seq, serve) through the SAME
    ``repro_torch.serve.pool.pool_tokens`` exact-integer ledger the scalar
    ``factors.term_env`` calls."""
    from repro_torch.models.transformer import LOSS_CHUNK
    n_pairs, n_seq = len(cols.pairs), len(cols.seqs)
    accum_1 = np.repeat(np.array([p[0] for p in cols.pairs], I64), n_seq)
    gb_1 = np.repeat(np.array([p[1] for p in cols.pairs], I64), n_seq)
    seq_1 = np.tile(np.array(cols.seqs, I64), n_pairs)
    serves = cols.serves
    serve_on = cols.kind != "train" \
        and any(s is not None for s in serves)
    expanded = pp > 1 and cols.kind == "train"
    if expanded:
        n_m = len(cols.mbs)
        accum_t = np.tile(accum_1, n_m)
        gb_t = np.tile(gb_1, n_m)
        seq_t = np.tile(seq_1, n_m)
        micro_t = np.repeat(np.array(cols.mbs, I64), n_pairs * n_seq)
        eff_m = np.maximum(micro_t, 1)       # PredictContext.eff_microbatches
    elif serve_on:
        n_srv = len(serves)
        accum_t = np.tile(accum_1, n_srv)
        gb_t = np.tile(gb_1, n_srv)
        seq_t = np.tile(seq_1, n_srv)
        srv_t = np.repeat(np.arange(n_srv, dtype=I64), n_pairs * n_seq)
        eff_m = np.ones_like(gb_t)
    else:
        accum_t, gb_t, seq_t = accum_1, gb_1, seq_1
        eff_m = np.ones_like(gb_t)
    mb_t = np.maximum(np.maximum(gb_t // np.maximum(accum_t, 1), 1)
                      // eff_m, 1)           # PredictContext.pp_micro_batch
    gb_in = np.maximum(gb_t // eff_m, 1)     # _input_bytes batch dim
    if cfg.encdec:
        ratio = cfg.encdec.enc_seq_ratio
        # exact Python int(seq * ratio), as make_context computes it
        enc_t = np.array([int(s * ratio) for s in seq_t.tolist()], I64)
    else:
        enc_t = np.zeros(len(seq_t), I64)
    if serve_on:
        import dataclasses
        from repro_torch.serve.pool import pool_tokens
        seq_l, srv_l = seq_t.tolist(), srv_t.tolist()
        pool_tok = np.array([pool_tokens(s, serves[i])
                             for s, i in zip(seq_l, srv_l)], I64)
        nohit = [None if sp is None else dataclasses.replace(sp, hit_bp=0)
                 for sp in serves]
        pool_tok0 = np.array([pool_tokens(s, nohit[i])
                              for s, i in zip(seq_l, srv_l)], I64)
        active_t = np.array([serves[i] is not None for i in srv_l], bool)
    else:
        srv_t = np.zeros(len(seq_t), I64)
        pool_tok = pool_tok0 = seq_t             # neutral: pool_tok == slen
        active_t = np.zeros(len(seq_t), bool)
    env = {"mb": mb_t, "gb": gb_t, "seq": seq_t, "enc": enc_t,
           "slen": seq_t,                      # make_context: max_len=seq
           "chunk": np.minimum(LOSS_CHUNK, seq_t),
           "qc": np.minimum(F.FLASH_CHUNK, seq_t),
           "tok_cross": np.where(enc_t > 0, enc_t, seq_t),
           "cache_mult": 3 if (cols.backend == "cpu"
                               and cols.kind == "decode") else 1,
           "pool_tok": pool_tok,
           # derived (not TermSpec dims)
           "_pool_tok0": pool_tok0, "_srv_t": srv_t, "_active_t": active_t,
           "_eff_m": eff_m, "_gb_in": gb_in, "_expanded": expanded,
           "_serve_expanded": serve_on}
    return env


@dataclass
class _StageTables:
    """Component-group tables for one (arch, pipeline stage) over
    (pp-group meshes x knob tuples)."""

    static_sum: np.ndarray          # (n_mesh, n_opt, n_off, 2) [cls: 2/4]
    opt_trans: np.ndarray           # (n_mesh, n_opt, n_off)
    static_scaled: Optional[np.ndarray]   # profile-scaled static group
    saved: np.ndarray               # (n_remat_eval, n_mesh, T)
    transient: np.ndarray           # (n_mesh, T)
    loss: np.ndarray                # (n_mesh, T)
    inputs: np.ndarray              # (n_mesh, T)
    cache: np.ndarray               # (n_mesh, T)
    boundary: np.ndarray            # (n_mesh, T)
    embed: int
    # out-copy split of the static group for the liveness assembly:
    # static_sum folds param + out_copy + opt + grad together, but the
    # liveness base component excludes the out_copy (it is live only in
    # the optimizer-update window) — stored separately so base can be
    # recovered as static_sum - outcopy byte-exactly
    outcopy: np.ndarray             # (n_mesh,)
    outcopy_scaled: Optional[np.ndarray]  # (n_mesh,) profile-scaled
    # serving-fleet tables (None unless the env is serve-expanded, so
    # non-serve grids pay zero extra gathers in the composition)
    pool: Optional[np.ndarray] = None         # (n_mesh, T) paged-KV pool
    pool_saved: Optional[np.ndarray] = None   # prefix-hit savings info
    draft: Optional[np.ndarray] = None        # first stage only
    # Eq.1 offload tier: host-resident optimizer bytes per offload flag
    # (None on grids without the knob — zero gathers in the composition)
    host_opt: Optional[np.ndarray] = None     # (n_mesh, n_opt, n_off)


def _stage_tables(cfg, model, rows, rules, rep_ctx,
                  cols: CellColumns, env: dict, profile,
                  opt_res: tuple, remat_eval: tuple,
                  mesh_ids, stage: int, pp: int,
                  drafts: Optional[dict] = None) -> _StageTables:
    """Tables for ONE pipeline stage's rows over the meshes in
    ``mesh_ids`` (the whole model when ``pp == 1``) — the columnar twin
    of ``compute_static`` / ``compute_acts`` / ``compute_overheads`` on
    that stage (the stash multiplier is applied by the caller)."""
    kind, backend = cols.kind, cols.backend
    first, last = stage == 0, stage == pp - 1
    meshes = [cols.meshes[i] for i in mesh_ids]
    n_mesh = len(meshes)
    T = len(env["mb"])
    axes_names = sorted({a for m in meshes for a in m})
    sizes1 = {a: np.array([m.get(a, 1) for m in meshes], I64)
              for a in axes_names}
    sizes2 = {a: v[:, None] for a, v in sizes1.items()}
    shape2 = (n_mesh, T)
    full = lambda v: np.broadcast_to(np.asarray(v, I64), shape2)
    # context-parallel gate: the ring-attention send/recv transient
    # exists only on meshes whose `context` axis exceeds 1 (the scalar
    # twin gates on ctx.cp > 1 in factors._ring_bytes)
    cp_gt1 = (sizes1[CONTEXT_AXIS] > 1)[:, None] \
        if CONTEXT_AXIS in sizes1 else np.zeros((n_mesh, 1), bool)

    def ring_term(r):
        rspec = F.ring_kv_spec(r)
        if rspec is None or kind == "decode" or not cp_gt1.any():
            return 0
        ring = np.broadcast_to(
            eval_term_batch(rspec, env, sizes2, rules), shape2)
        return np.where(cp_gt1, ring, 0)

    # -- static group (params / grads / optimizer states / output copy) --
    train = kind == "train"
    param_arr = np.zeros(n_mesh, I64)
    outcopy_arr = np.zeros(n_mesh, I64)
    grad_arr = np.zeros((2, n_mesh), I64)          # cls: eff_grad 2 / 4
    opt_arr = np.zeros((len(opt_res), n_mesh), I64)
    p_extra = ("data",) if cfg.fsdp else ()
    for r in rows:
        row_param = np.zeros(n_mesh, I64)
        for p in r.layer.params.values():
            shape, axes = F._stacked(p, r)
            pden = batch_shard_factor(shape, axes, sizes1, rules, p_extra)
            row_param = row_param + p.nbytes * r.repeat // pden
            if train and r.trainable:
                nsize = p.size * r.repeat
                grad_arr[0] += nsize * 2 // pden
                grad_arr[1] += nsize * 4 // pden
                # ZeRO: opt states always shard over data on top of TP
                oden = pden if cfg.fsdp else batch_shard_factor(
                    shape, axes, sizes1, rules, ("data",))
                rep_o = 1 if r.scanned else r.repeat
                for oi, oname in enumerate(opt_res):
                    ob = F.opt_bytes_for(p, shape, oname,
                                         oname != "adafactor")
                    opt_arr[oi] += ob * rep_o // oden
        param_arr += row_param
        if train and r.trainable:
            outcopy_arr += row_param
    # Eq.1 offload tier: per offload flag the resident optimizer bytes
    # are either the full state (off) or the double-buffered staging
    # window over it (on), with the displaced total recorded as
    # host_opt.  Per-element ints through factors.offload_staged_bytes
    # so staged values match the scalar path byte-for-byte.
    offs = cols.offs
    n_off = len(offs)
    # vectorized offload_staged_bytes: same 2 * ceil(o / OFFLOAD_BUCKETS)
    # exact-int expression, broadcast over (mesh, opt, off)
    opt_dev = opt_arr.T[:, :, None]                   # (n_mesh, n_opt, 1)
    staged = 2 * (-(-opt_dev // F.OFFLOAD_BUCKETS))
    off_mask = np.array(offs, bool)[None, None, :]
    opt_eff = np.where(off_mask, staged,
                       np.broadcast_to(opt_dev,
                                       (n_mesh, len(opt_res), n_off)))
    host_opt = None
    if train and any(offs):
        host_opt = np.zeros((n_mesh, len(opt_res), n_off), I64)
        for fi, off in enumerate(offs):
            if off:
                host_opt[:, :, fi] = opt_arr.T
    static_sum = (param_arr + outcopy_arr)[:, None, None, None] \
        + opt_eff[:, :, :, None] + grad_arr.T[:, None, None, :]
    frac = rep_ctx.opt_transient_frac
    if frac:
        # float64 multiply + truncation toward zero, elementwise — the
        # vector twin of the scalar ``int(frac * int(opt_eff))``
        opt_trans = (frac * opt_eff.astype(np.float64)).astype(I64)
    else:
        opt_trans = np.zeros((n_mesh, len(opt_res), n_off), I64)
    static_scaled = None
    outcopy_scaled = None
    if profile is not None:
        c_s = profile.coef("static")
        # np.rint is round-half-even, matching the scalar path's
        # ``int(round(v * c_s))`` per static term
        sc = lambda v: np.rint(np.asarray(v, np.float64)
                               * c_s).astype(I64)
        outcopy_scaled = sc(outcopy_arr)
        static_scaled = (sc(param_arr) + outcopy_scaled
                         )[:, None, None, None] \
            + sc(opt_eff)[:, :, :, None] \
            + sc(grad_arr.T)[:, None, None, :]

    # -- activation group (saved-for-backward + worst transient) ---------
    zeros2 = np.zeros(shape2, I64)
    saved_stack = np.zeros((len(remat_eval), n_mesh, T), I64)
    if kind == "train":
        worst = zeros2
        blocks: dict = {}
        for r in rows:
            entries = _act_entries(r)
            if not entries:
                continue
            saved_vals, trans_vals, by_name = [], [], {}
            for name, t in entries:
                dims = _resolve_dims(_sym_dims(t), env)
                taxes = t.axes if t.axes else (None,) * len(dims)
                denom = np.maximum(
                    batch_shard_factor(dims, taxes, sizes2, rules), 1)
                q = _dims_prod(dims)
                sv = q * F.eff_act_nbytes(dtype_bytes(t.dtype), rep_ctx,
                                          True) // denom
                tv = q * F.eff_act_nbytes(dtype_bytes(t.dtype), rep_ctx,
                                          False) // denom
                saved_vals.append(sv)
                trans_vals.append(tv)
                by_name[name] = sv
            S_full = sum(saved_vals)
            T_full = sum(trans_vals)
            S_dots = sum((v for t, v in zip(r.layer.acts, saved_vals)
                          if F._is_dot_term(t)), np.asarray(0, I64))
            first_act = r.layer.acts[0]
            S_block = by_name.get(first_act.name) \
                if (first_act.name.endswith(".in")
                    and r.layer.kind in ("rmsnorm", "layernorm")) else None
            inv = r.layer.meta.get("invocation_repeat")
            if r.trainable:
                for ri, rname in enumerate(remat_eval):
                    if inv:
                        saved_stack[ri] += S_full * inv
                    elif (not r.scanned) or rname == "none":
                        saved_stack[ri] += S_full * r.repeat
                    elif rname == "dots":
                        saved_stack[ri] += S_dots * r.repeat
                    elif S_block is not None:
                        saved_stack[ri] += S_block * r.repeat
            tspec = F.flash_tile_spec(r)
            tile = 0 if tspec is None \
                else eval_term_batch(tspec, env, sizes2, rules)
            ring = ring_term(r)
            t_row = 2 * T_full + 2 * tile + ring if r.trainable \
                else T_full + tile + ring
            if r.scanned:
                blocks[r.module_path] = blocks.get(r.module_path, 0) + t_row
            else:
                worst = np.maximum(worst, t_row)
        bmax = zeros2
        for v in blocks.values():
            bmax = np.maximum(bmax, v)
        transient = np.maximum(worst, bmax)
    elif kind == "prefill":
        blocks = {}
        for r in rows:
            if not r.scanned:
                continue
            t_row = np.asarray(0, I64)
            entries = _act_entries(r)
            if entries:
                T_full = np.asarray(0, I64)
                for name, t in entries:
                    dims = _resolve_dims(_sym_dims(t), env)
                    taxes = t.axes if t.axes else (None,) * len(dims)
                    denom = np.maximum(
                        batch_shard_factor(dims, taxes, sizes2, rules), 1)
                    T_full = T_full + _dims_prod(dims) \
                        * F.eff_act_nbytes(dtype_bytes(t.dtype), rep_ctx,
                                           False) // denom
                tspec = F.flash_tile_spec(r)
                tile = 0 if tspec is None \
                    else eval_term_batch(tspec, env, sizes2, rules)
                t_row = T_full + tile + ring_term(r)
            blocks[r.module_path] = blocks.get(r.module_path, 0) + t_row
        transient = zeros2
        for v in blocks.values():
            transient = np.maximum(transient, v)
    else:                                           # decode
        transient = zeros2
        for group in PR.decode_transient_groups(rows):
            t = sum(eval_term_batch(s, env, sizes2, rules) for s in group)
            transient = np.maximum(transient, t)

    # -- overhead group (loss head, inputs, caches, boundary buffers) ----
    if last:
        loss = full(sum(eval_term_batch(s, env, sizes2, rules)
                        for s in PR.loss_specs(cfg, kind)))
    else:
        loss = full(0)
    pool = pool_saved = draft = None
    if kind == "train":
        cache = full(0)
    elif not env["_serve_expanded"]:
        cache = full(sum((eval_term_batch(s, env, sizes2, rules)
                          for s in PR.cache_specs(rows)),
                         np.asarray(0, I64)))
    else:
        # paged-KV split (scalar twin: predictor._cache_bytes /
        # _pool_terms on this stage's rows): the slen-growing cache terms
        # price at pool_tok tokens per sequence; serve-active cells keep
        # only the fixed remainder in cache and move the paged part to
        # the pool table, while serve=None cells (pool_tok == slen there)
        # recompose the contiguous cache exactly as fixed + paged.
        active2 = np.broadcast_to(env["_active_t"][None, :], shape2)
        fixed = full(sum((eval_term_batch(s, env, sizes2, rules)
                          for s in PR.fixed_cache_specs(rows)),
                         np.asarray(0, I64)))
        paged = full(sum((eval_term_batch(s, env, sizes2, rules)
                          for s in PR.pool_specs(rows)),
                         np.asarray(0, I64)))
        cache = np.where(active2, fixed, fixed + paged)
        pool = np.where(active2, paged, 0)
        if any(s is not None and s.hit_bp for s in cols.serves):
            env0 = dict(env)
            env0["pool_tok"] = env["_pool_tok0"]
            paged0 = full(sum((eval_term_batch(s, env0, sizes2, rules)
                               for s in PR.pool_specs(rows)),
                              np.asarray(0, I64)))
            pool_saved = np.where(active2, paged0 - paged, 0)
        else:
            pool_saved = np.zeros(shape2, I64)
        if first and drafts:
            # speculative-decode draft residency (scalar twin:
            # predictor.draft_residency_bytes): the draft's params under
            # ITS OWN rules + fsdp flag, plus its KV pool and fixed
            # caches at the cell's serve knobs — first stage only, per-T
            # masked to the cells whose spec names this draft
            draft = np.zeros(shape2, I64)
            srv_t = env["_srv_t"]
            for dname, (dcfg, drows, drules) in drafts.items():
                dmask = np.array(
                    [sp is not None and sp.draft_arch == dname
                     for sp in cols.serves], bool)[srv_t]
                if not dmask.any():
                    continue
                d_extra = ("data",) if dcfg.fsdp else ()
                dparams = np.zeros(n_mesh, I64)
                for r in drows:
                    for p in r.layer.params.values():
                        dshape, daxes = F._stacked(p, r)
                        dden = batch_shard_factor(dshape, daxes, sizes1,
                                                  drules, d_extra)
                        dparams = dparams + p.nbytes * r.repeat // dden
                dterms = full(sum(
                    (eval_term_batch(s, env, sizes2, drules)
                     for s in (PR.pool_specs(drows)
                               + PR.fixed_cache_specs(drows))),
                    np.asarray(0, I64)))
                draft = np.where(dmask[None, :],
                                 dparams[:, None] + dterms, draft)
    embed = PR.embed_gather_const(rows, backend)
    bmult = PR.boundary_mult(stage, pp, kind)
    if bmult:
        boundary = full(bmult * sum(
            eval_term_batch(s, env, sizes2, rules)
            for s in PR.boundary_specs(cfg, kind)))
    else:
        boundary = full(0)

    if first:
        from repro_torch.configs import ShapeConfig
        gb_in, seq_t = env["_gb_in"], env["seq"]
        gs_index: dict = {}
        gs_order: list = []
        for g, s in zip(gb_in.tolist(), seq_t.tolist()):
            if (g, s) not in gs_index:
                gs_index[(g, s)] = len(gs_order)
                gs_order.append((g, s))
        t_to_gs = np.array([gs_index[(g, s)]
                            for g, s in zip(gb_in.tolist(),
                                            seq_t.tolist())], I64)
        input_gs = np.zeros((n_mesh, len(gs_order)), I64)
        for gi, (g, s) in enumerate(gs_order):
            tot = np.zeros(n_mesh, I64)
            for arr in model.batch_spec(
                    ShapeConfig("tmp", s, g, kind)).values():
                ax = ("batch",) + (None,) * (len(arr.shape) - 1)
                den = batch_shard_factor(arr.shape, ax, sizes1, rules)
                tot += math.prod(arr.shape) * dtype_bytes(arr.dtype) \
                    // np.maximum(den, 1)
            input_gs[:, gi] = tot
        inputs = input_gs[:, t_to_gs]
    else:
        inputs = full(0)

    return _StageTables(
        static_sum=static_sum, opt_trans=opt_trans,
        static_scaled=static_scaled,
        saved=np.ascontiguousarray(
            np.broadcast_to(saved_stack, (len(remat_eval),) + shape2)),
        transient=full(transient), loss=loss, inputs=inputs, cache=cache,
        boundary=boundary, embed=embed, outcopy=outcopy_arr,
        outcopy_scaled=outcopy_scaled, pool=pool, pool_saved=pool_saved,
        draft=draft, host_opt=host_opt)


def _stage_tables_jobs(cfg, model, rows, rules, rep_ctx, cols, env,
                       profile, opt_res, remat_eval, mesh_ids,
                       stage: int, pp: int, jobs: int,
                       drafts: Optional[dict] = None) -> _StageTables:
    """``_stage_tables`` with the mesh axis split over worker threads
    (order-identical results)."""
    mesh_ids = list(mesh_ids)
    if jobs <= 1 or len(mesh_ids) <= 1:
        return _stage_tables(cfg, model, rows, rules, rep_ctx, cols, env,
                             profile, opt_res, remat_eval, mesh_ids,
                             stage, pp, drafts)
    from concurrent.futures import ThreadPoolExecutor
    chunks = [c.tolist() for c in
              np.array_split(np.asarray(mesh_ids), jobs) if len(c)]
    with ThreadPoolExecutor(max_workers=len(chunks)) as ex:
        parts = list(ex.map(
            lambda ids: _stage_tables(cfg, model, rows, rules, rep_ctx,
                                      cols, env, profile, opt_res,
                                      remat_eval, ids, stage, pp, drafts),
            chunks))
    first = parts[0]
    cat = lambda pick, axis: np.concatenate(
        [pick(p) for p in parts], axis=axis)
    opt_cat = lambda pick: None if pick(first) is None \
        else cat(pick, 0)
    return _StageTables(
        static_sum=cat(lambda p: p.static_sum, 0),
        opt_trans=cat(lambda p: p.opt_trans, 0),
        static_scaled=opt_cat(lambda p: p.static_scaled),
        saved=cat(lambda p: p.saved, 1),
        transient=cat(lambda p: p.transient, 0),
        loss=cat(lambda p: p.loss, 0),
        inputs=cat(lambda p: p.inputs, 0),
        cache=cat(lambda p: p.cache, 0),
        boundary=cat(lambda p: p.boundary, 0),
        embed=first.embed,
        outcopy=cat(lambda p: p.outcopy, 0),
        outcopy_scaled=opt_cat(lambda p: p.outcopy_scaled),
        pool=opt_cat(lambda p: p.pool),
        pool_saved=opt_cat(lambda p: p.pool_saved),
        draft=opt_cat(lambda p: p.draft),
        host_opt=opt_cat(lambda p: p.host_opt))


# ---------------------------------------------------------------------------
# the columnar sweep entry point
# ---------------------------------------------------------------------------


def _intern(table: dict, names: list, name: str) -> int:
    if name not in table:
        table[name] = len(names)
        names.append(name)
    return table[name]


def _draft_states(engine, cols) -> dict:
    """Speculative-decode draft states: one (cfg, rows, rules) per
    distinct draft arch on the serve axis, parsed under FULL_TRAIN
    exactly like the scalar ``predictor._draft_state`` memo."""
    from repro_torch.launch.mesh import arch_rules
    drafts: dict = {}
    for s in cols.serves:
        if s is not None and s.draft_arch and s.draft_arch not in drafts:
            dcfg, _, drows = engine._arch_state(
                SW.normalize_arch(s.draft_arch), FULL_TRAIN)
            drafts[s.draft_arch] = (dcfg, drows,
                                    arch_rules(dcfg, cols.kind))
    return drafts


def _finalize_results(grid, cols: CellColumns, t0: float,
                      peak, pool_arr, draft_arr, hit_arr, off_arr,
                      opt_names, remat_names,
                      res_opt_c, res_remat_c,
                      slack_arr=None) -> "SW.SweepResults":
    """Assemble the SweepResults store from the per-cell peak/provenance
    columns — shared by the numpy and torch engines so both produce
    structurally identical results."""
    from repro_torch.launch.mesh import mesh_chips
    budget = np.array([int(PL.chip_hbm(c) * grid.headroom)
                       for c in cols.chips], I64)[cols.chip_c]
    n_chips_by_mesh = np.array([mesh_chips(m) for m in cols.meshes], I64)
    columns = ColumnarResults(
        n=cols.n, kind=cols.kind, backend=cols.backend,
        arch_names=cols.arches, chip_names=cols.chips, meshes=cols.meshes,
        n_chips_by_mesh=n_chips_by_mesh,
        opt_names=tuple(opt_names), remat_names=tuple(remat_names),
        sched_names=cols.scheds,
        arch_c=cols.arch_c, chip_c=cols.chip_c, mesh_c=cols.mesh_c,
        opt_c=res_opt_c, remat_c=res_remat_c, sched_c=cols.sched_c,
        microbatches=cols.micro,
        grad_accum=cols.accum, global_batch=cols.gb, seq_len=cols.seq,
        peak_bytes=peak, budget_bytes=budget, fits=peak <= budget,
        serves=cols.serves, srv_c=cols.srv_c, pool_bytes=pool_arr,
        draft_bytes=draft_arr, hit_saved_bytes=hit_arr,
        offs=cols.offs, off_c=cols.off_c, offload_bytes=off_arr,
        overlap_slack_bytes=slack_arr)
    return SW.SweepResults(grid=grid, columns=columns,
                           elapsed_s=time.perf_counter() - t0)


def sweep_columnar(engine, grid, jobs: int = 1) -> "SW.SweepResults":
    """Evaluate every cell of ``grid`` columnarly; byte-identical to the
    per-cell path (``SweepEngine.evaluate`` per ``grid.cells()`` cell)."""
    t0 = time.perf_counter()
    # same up-front ep/cp + serve validation the cell path hits via
    # grid.cells() -> make_context -> planner.check_parallel/check_serve
    grid.check_parallel()
    grid.check_serve()
    grid.check_offload()
    grid.check_assembly()
    live_mode = grid.assembly == "liveness"
    cols = build_columns(grid)
    if cols.n == 0:
        return SW.SweepResults(grid=grid, results=[],
                               elapsed_s=time.perf_counter() - t0)
    profile = grid.profile
    n = cols.n
    n_pairs, n_seq = len(cols.pairs), len(cols.seqs)
    peak = np.zeros(n, I64)
    opt_names: list = []
    remat_names: list = []
    opt_tbl: dict = {}
    remat_tbl: dict = {}
    res_opt_c = np.zeros(n, I64)
    res_remat_c = np.zeros(n, I64)
    pp_of = np.array([int(m.get(PIPE_AXIS, 1)) for m in cols.meshes], I64)
    is_gpipe_sched = np.array([s == "gpipe" for s in cols.scheds], bool)
    from repro_torch.launch.mesh import arch_rules
    drafts = _draft_states(engine, cols)
    pool_arr = np.zeros(n, I64)
    draft_arr = np.zeros(n, I64)
    hit_arr = np.zeros(n, I64)
    # offload provenance is train-only (check_offload rejects it on
    # serve kinds), so the serve and offload branches never both apply
    off_grp = cols.kind == "train" and any(cols.offs)
    off_arr = np.zeros(n, I64)
    slack_arr = np.zeros(n, I64) if live_mode else None
    block = n // len(cols.arches)
    for ai, arch in enumerate(cols.arches):
        sl = slice(ai * block, (ai + 1) * block)
        cfg, model, rows = engine._arch_state(arch, grid.policy)
        rules = arch_rules(cfg, cols.kind)
        opt_res = tuple(o or cfg.optimizer for o in cols.opts)
        remat_res = tuple(r or cfg.remat for r in cols.remats)
        remat_eval = tuple(dict.fromkeys(remat_res))
        remat_idx = np.array([remat_eval.index(r) for r in remat_res], I64)
        # backend-derived scalars (bf16 multipliers, opt-transient frac)
        rep_ctx = PL.make_context(
            cfg, dict(cols.meshes[0]), kind=cols.kind,
            global_batch=int(cols.gb[sl][0]), seq_len=int(cols.seq[sl][0]),
            backend=cols.backend)

        m_c = cols.mesh_c[sl]
        o_c = cols.opt_c[sl]
        f_c = cols.off_c[sl]
        t2_full = (cols.mb_c[sl] * n_pairs + cols.pair_c[sl]) * n_seq \
            + cols.seq_c[sl]
        t2_flat = cols.pair_c[sl] * n_seq + cols.seq_c[sl]
        t2_srv = (cols.srv_c[sl] * n_pairs + cols.pair_c[sl]) * n_seq \
            + cols.seq_c[sl]
        r_codes = remat_idx[cols.remat_c[sl]]
        accum_col = cols.accum[sl]
        gpipe_col = is_gpipe_sched[cols.sched_c[sl]]
        chip_off = None
        if profile is not None:
            chip_off = np.array([profile.chip_offset(c)
                                 for c in cols.chips], I64)[cols.chip_c[sl]]

        arch_peak = np.zeros(block, I64)
        arch_pool = np.zeros(block, I64)
        arch_draft = np.zeros(block, I64)
        arch_hit = np.zeros(block, I64)
        arch_off = np.zeros(block, I64)
        arch_slack = np.zeros(block, I64)
        for pp in sorted(set(pp_of.tolist())):
            mesh_ids = np.flatnonzero(pp_of == pp)
            sel = np.isin(m_c, mesh_ids)
            if not sel.any():
                continue
            env = _knob_env(cfg, cols, pp)
            plan = engine._stage_plan(arch, grid.policy, pp)
            lidx = np.full(len(cols.meshes), -1, I64)
            lidx[mesh_ids] = np.arange(len(mesh_ids), dtype=I64)
            lm = lidx[m_c[sel]]
            serve_grp = env["_serve_expanded"]
            t2 = (t2_full if env["_expanded"]
                  else t2_srv if serve_grp else t2_flat)[sel]
            osel = o_c[sel]
            fsel = f_c[sel]
            rsel = r_codes[sel]
            eff_m_cells = env["_eff_m"][t2]
            cls = ((accum_col[sel] > 1) | (eff_m_cells > 1)).astype(I64)
            gp = gpipe_col[sel]
            best = np.zeros(int(sel.sum()), I64)
            if serve_grp:
                b_pool = np.zeros_like(best)
                b_draft = np.zeros_like(best)
                b_hit = np.zeros_like(best)
            if off_grp:
                b_off = np.zeros_like(best)
            if live_mode:
                b_slack = np.zeros_like(best)
            for s, srows in enumerate(plan.stages):
                tabs = _stage_tables_jobs(
                    cfg, model, list(srows), rules, rep_ctx, cols, env,
                    profile, opt_res, remat_eval, mesh_ids, s, pp, jobs,
                    drafts)
                # schedule stash: GPipe stages hold all m microbatch
                # activation sets, 1F1B stage s holds min(pp - s, m)
                stash = np.maximum(
                    np.where(gp, eff_m_cells,
                             np.minimum(pp - s, eff_m_cells)), 1)
                saved = tabs.saved[rsel, lm, t2] * stash
                trans = tabs.transient[lm, t2]
                loss = tabs.loss[lm, t2]
                inp = tabs.inputs[lm, t2]
                cache = tabs.cache[lm, t2]
                bnd = tabs.boundary[lm, t2]
                if profile is None:
                    speak = (tabs.static_sum[lm, osel, fsel, cls]
                             + tabs.opt_trans[lm, osel, fsel]
                             + saved + trans + bnd + tabs.embed
                             + loss + inp + cache)
                else:
                    # assemble() folds embed gathers + boundary buffers +
                    # the optimizer-update transient into act_transient
                    # BEFORE the profile scales it; loss/input/cache
                    # round separately, exactly like apply()
                    speak = (tabs.static_scaled[lm, osel, fsel, cls]
                             + profile.scale_batch(saved, "act_saved")
                             + profile.scale_batch(
                                 trans + bnd + tabs.embed
                                 + tabs.opt_trans[lm, osel, fsel],
                                 "act_transient")
                             + profile.scale_batch(loss, "overhead")
                             + profile.scale_batch(inp, "overhead")
                             + profile.scale_batch(cache, "overhead")
                             + chip_off[sel])
                if serve_grp:
                    # paged pool scales with the cache group, the draft
                    # model's residency with the statics (profile.apply);
                    # the peak-stage provenance is strictly-greater like
                    # predictor.predict, so ties keep the earliest stage
                    pool = tabs.pool[lm, t2]
                    psv = tabs.pool_saved[lm, t2]
                    drf = tabs.draft[lm, t2] if tabs.draft is not None \
                        else np.zeros_like(pool)
                    if profile is not None:
                        pool = profile.scale_batch(pool, "overhead")
                        psv = profile.scale_batch(psv, "overhead")
                        drf = profile.scale_batch(drf, "static")
                    speak = speak + pool + drf
                if live_mode:
                    # liveness assembly: component columns -> event-delta
                    # stack -> segmented cummax (twin of
                    # predictor.liveness_values + liveness.replay)
                    ecol = np.full_like(trans, tabs.embed)
                    ot = tabs.opt_trans[lm, osel, fsel]
                    if profile is None:
                        comps = {
                            "base": (tabs.static_sum[lm, osel, fsel, cls]
                                     - tabs.outcopy[lm]),
                            "inputs": inp, "cache": cache, "loss": loss,
                            "saved": saved, "boundary": bnd,
                            "transient": trans, "embed": ecol,
                            "opt_transient": ot,
                            "out_copy": tabs.outcopy[lm]}
                    else:
                        # telescoped act_transient deltas (cumulative
                        # scaled prefixes in liveness.TRANSIENT_ORDER) so
                        # their sum equals the legacy group byte-exactly
                        sc_t = lambda v: profile.scale_batch(
                            v, "act_transient")
                        p1 = sc_t(ecol)
                        p2 = sc_t(ecol + bnd)
                        p3 = sc_t(ecol + bnd + trans)
                        p4 = sc_t(ecol + bnd + trans + ot)
                        comps = {
                            "base": (tabs.static_scaled[lm, osel, fsel,
                                                        cls]
                                     - tabs.outcopy_scaled[lm]
                                     + chip_off[sel]),
                            "inputs": profile.scale_batch(inp, "overhead"),
                            "cache": profile.scale_batch(cache,
                                                         "overhead"),
                            "loss": profile.scale_batch(loss, "overhead"),
                            "saved": profile.scale_batch(saved,
                                                         "act_saved"),
                            "embed": p1, "boundary": p2 - p1,
                            "transient": p3 - p2,
                            "opt_transient": p4 - p3,
                            "out_copy": tabs.outcopy_scaled[lm]}
                    if serve_grp:
                        comps["pool"] = pool
                        comps["draft"] = drf
                    lpeak = liveness_peak_batch(_liveness_deltas(
                        cols.kind, comps, best.shape[0]))
                    if not (lpeak <= speak).all():
                        raise AssertionError(
                            "liveness peak exceeded legacy peak")
                    cur = lpeak
                else:
                    cur = speak
                if serve_grp or off_grp or live_mode:
                    upd = cur > best
                    best = np.where(upd, cur, best)
                    if live_mode:
                        b_slack = np.where(upd, speak - lpeak, b_slack)
                    if serve_grp:
                        b_pool = np.where(upd, pool, b_pool)
                        b_draft = np.where(upd, drf, b_draft)
                        b_hit = np.where(upd, psv, b_hit)
                    if off_grp:
                        # host-tier provenance follows the same
                        # strictly-greater peak-stage rule: the reported
                        # offload_bytes are the winning stage's
                        # host-resident optimizer total (unscaled — host
                        # DRAM is outside the HBM profile, mirroring
                        # CalibrationProfile.apply)
                        hop = tabs.host_opt[lm, osel, fsel] \
                            if tabs.host_opt is not None \
                            else np.zeros_like(best)
                        b_off = np.where(upd, hop, b_off)
                else:
                    best = np.maximum(best, speak)
            arch_peak[sel] = best
            if serve_grp:
                arch_pool[sel] = b_pool
                arch_draft[sel] = b_draft
                arch_hit[sel] = b_hit
            if off_grp:
                arch_off[sel] = b_off
            if live_mode:
                arch_slack[sel] = b_slack
        peak[sl] = arch_peak
        pool_arr[sl] = arch_pool
        draft_arr[sl] = arch_draft
        hit_arr[sl] = arch_hit
        off_arr[sl] = arch_off
        if live_mode:
            slack_arr[sl] = arch_slack
        per_opt = np.array([_intern(opt_tbl, opt_names, o)
                            for o in opt_res], I64)
        res_opt_c[sl] = per_opt[o_c]
        per_remat = np.array([_intern(remat_tbl, remat_names, r)
                              for r in remat_res], I64)
        res_remat_c[sl] = per_remat[cols.remat_c[sl]]
    return _finalize_results(grid, cols, t0, peak, pool_arr, draft_arr,
                             hit_arr, off_arr, opt_names, remat_names,
                             res_opt_c, res_remat_c, slack_arr)
