"""Torch-lowered columnar engine: the device twin of
:func:`repro_torch.core.batch.sweep_columnar`.

The host columnar path stays the byte-exact yardstick; this module
re-expresses its per-cell composition as a handful of table gathers so the
O(cells) work runs as int64 tensor ops on a device:

* the per-stage component tables come from the SAME host
  :func:`repro_torch.core.batch._stage_tables` the numpy engine uses (one
  source of truth for every TermSpec / shard-factor evaluation), run
  twice by :func:`repro_torch.kernels.shard_factor.resolve_batched`: the
  first run records every shard denominator the stage's build asks for,
  one batched ``shard_factor`` call resolves them all (one upload, one
  launch of the CUDA kernel on a CUDA device — its plain version on the
  CPU — and one read-back), the second run builds the tables from the
  answers;
* the tables are **folded** on the host into compound gather tables — the
  saved-activation table absorbs the schedule stash multiplier on its knob
  axis, the static group absorbs the optimizer-update transient, and a
  calibration profile's per-term-group ``rint`` scaling is applied in
  table space, in float64 (``CalibrationProfile.scale_batch``).  Folding
  is exact: every fold either pre-applies an elementwise op that commutes
  with the gather (``rint(c*x)``, ``x*stash[t2]``) or merges tables indexed
  by the same code tuple (integer addition), so each cell's folded value
  is bit-equal to the numpy engine's gather-then-combine value.  The
  act_transient group does not add under ``rint``, so a profile folds it
  into one ``ctr`` table over ``(opt, off, t2)``;
* the composition domain drops from ``n_cells`` to ``n_meshes x inner``
  knob tuples: the chip axis never enters the stage max (a profile's
  per-chip offset is a per-stage constant, so adding it to each chip's
  slice after the max — outside the strictly-greater peak-stage compare,
  which it shifts uniformly — is exact), and the per-chip HBM budget is
  applied by the shared result finalizer;
* a Python loop walks the pipeline stages of the stacked tables with
  running ``(best, pool, draft, hit, offload, slack)`` tensors, reproducing
  the numpy loop's strictly-greater peak-stage provenance update;
  everything is ``torch.int64`` (byte counts overflow int32);
* under the liveness assembly each stage's component gathers are contracted
  with the step kind's event program into an ``(n_events, n_lm * inner)``
  delta stack ON THE DEVICE and reduced by the ``segmented_cummax`` kernel
  — one launch per (arch, pipeline-degree group, stage), no host round
  trip;
* folded tables are cached on the engine AS DEVICE TENSORS, keyed by
  everything that determines their values (arch, policy, meshes, knob
  axes, profile hash, assembly, device), so a repeated sweep skips the
  host table build and the upload and goes straight to the device
  composition.

A learned residual model is applied per cell, which this engine does not
do: it refuses such grids (``engine='numpy'`` takes them).

Byte-identity to the reference package's numpy engine is asserted in
tests/test_torch_sweep.py; on a CUDA device ``chip_smoke.py`` holds this
engine against the host columnar path column for column.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from repro_torch.core import batch as B
from repro_torch.core import liveness as LV
from repro_torch.core import planner as PL
from repro_torch.core import sweep as SW
from repro_torch.kernels import segmented_cummax as SC
from repro_torch.kernels import shard_factor as SF
from repro_torch.mesh_ctx import PIPE_AXIS

I64 = np.int64


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` unless the caller names another.  No
    CUDA device present is an error, never a quiet run on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "engine='torch' runs on a CUDA device and none is available; "
            "pass device='cpu' to run the composition on the host")
    return dev


# ---------------------------------------------------------------------------
# device stage-loop composition
# ---------------------------------------------------------------------------


def compose(tabs: dict, idx: tuple, n_lm: int, inner: int, *,
            serve: bool, off: bool, assembly: str, kind: str) -> tuple:
    """Compose the stage-stacked device tables ``tabs`` (leading axis =
    pipeline stage) over the ``(n_lm, inner)`` domain.

    ``idx`` holds the int64 device code vectors ``(c_aff, c_b, c_ctr, c_ho,
    t2)`` (each ``(inner,)``; ``c_ctr`` is empty without a profile's
    ``ctr`` table, ``c_ho`` when unused).  Returns the
    ``(best, pool, draft, hit, offload, slack)`` tensors, each
    ``(n_lm, inner)`` int64 on the tables' device — the winning stage is
    the first with a strictly greater peak, as in the host loop."""
    c_aff, c_b, c_ctr, c_ho, t2 = idx
    has_profile = "ctr" in tabs
    device = tabs["aff"].device
    zeros = lambda: torch.zeros((n_lm, inner), dtype=torch.int64,
                                device=device)
    best, bp, bd, bh, bo, bs = (zeros() for _ in range(6))
    take = lambda t, codes: torch.index_select(t, 1, codes)
    live = assembly == "liveness"
    if live:
        delta_rows = LV.compile_program(kind).delta_matrix()
    for s in range(tabs["aff"].shape[0]):
        xs = {k: v[s] for k, v in tabs.items()}
        if live:
            # under a profile the folded tables hold the telescoped
            # act_transient deltas, the last of them in ``ctr``
            ot = take(xs["ctr"], c_ctr) if has_profile \
                else take(xs["otr"], c_ho)
            comps = {
                "base": take(xs["aff"], c_aff),
                "inputs": take(xs["inp"], t2),
                "cache": take(xs["cch"], t2),
                "loss": take(xs["lss"], t2),
                "saved": take(xs["b"], c_b),
                "boundary": take(xs["bd"], t2),
                "transient": take(xs["tr"], t2),
                "embed": xs["emb"],
                "opt_transient": ot,
                "out_copy": xs["ocp"][:, None],
            }
            if serve:
                comps["pool"] = take(xs["pool"], t2)
                comps["draft"] = take(xs["drf"], t2)
            # legacy peak = plain sum of every component (the event deltas
            # partition it), needed for the slack provenance
            speak = zeros()
            for v in comps.values():
                speak = speak + v
            # event-delta stack: the cell-independent program's +-1
            # coefficients contracted against the component gathers
            deltas = torch.zeros((len(delta_rows), n_lm, inner),
                                 dtype=torch.int64, device=device)
            for ei, row in enumerate(delta_rows):
                for ci, coef in enumerate(row):
                    name = LV.COMPONENTS[ci]
                    if coef and name in comps:
                        deltas[ei] += coef * comps[name]
            cur = SC.segmented_cummax(
                deltas.view(len(delta_rows), n_lm * inner)
            ).view(n_lm, inner)
        else:
            speak = (take(xs["aff"], c_aff) + take(xs["b"], c_b)
                     + take(xs["base"], t2))
            if has_profile:
                speak = speak + take(xs["ctr"], c_ctr)
            if serve:
                p = take(xs["pool"], t2)
                d = take(xs["drf"], t2)
                speak = speak + p + d
            cur = speak
        if not (live or serve or off):
            best = torch.maximum(best, cur)
            continue
        upd = cur > best
        best = torch.where(upd, cur, best)
        if live:
            bs = torch.where(upd, speak - cur, bs)
        if serve:
            pool = comps["pool"] if live else p
            draft = comps["draft"] if live else d
            bp = torch.where(upd, pool, bp)
            bd = torch.where(upd, draft, bd)
            bh = torch.where(upd, take(xs["hit"], t2), bh)
        if off:
            bo = torch.where(upd, take(xs["ho"], c_ho), bo)
    return best, bp, bd, bh, bo, bs


# ---------------------------------------------------------------------------
# table folding (host, exact int64 arithmetic)
# ---------------------------------------------------------------------------


def _fold_stage(tabs: "B._StageTables", env, pp: int, stage: int,
                liveness: bool = False, profile=None) -> dict:
    """Fold one stage's component tables into compound gather tables.

    Returns 2-D ``(n_lm, K)`` arrays whose flattened trailing codes the
    composition gathers with:

    * ``aff``  — static group (+ optimizer transient when unscaled),
      code ``(opt*n_off + off)*2 + cls``;
    * ``b``    — saved activations with the schedule stash folded per
      (schedule-class, remat), code ``(gpipe*n_r + remat)*T + t2``;
    * ``base`` — transient+overhead terms indexed by ``t2`` alone;
    * ``ctr``  — profile only: the act_transient rint group
      (transient+boundary+embed+opt_trans), code ``(opt*n_off+off)*T+t2``;
    * ``pool/drf/hit`` (serve) and ``ho`` (offload provenance).

    Under the liveness assembly the event-program components stay separate
    instead (``tr``/``bd``/``lss``/``inp``/``cch``/``otr``/``ocp``/``emb``)
    and ``aff`` becomes the persistent base: the static group MINUS the
    out-copy, which is live only in the optimizer-update window.  Under a
    profile ``emb``/``bd``/``tr``/``ctr`` hold the TELESCOPED act_transient
    deltas (cumulative scaled prefixes in ``liveness.TRANSIENT_ORDER``,
    ``ctr`` replacing ``otr``), so their sum gives back the legacy rint
    group exactly.  Every scaling is ``profile.scale_batch``: a float64
    product and round-half-even, on the host.
    """
    eff_m = env["_eff_m"]
    # schedule stash per knob tuple: 1F1B stage s stashes min(pp-s, m),
    # GPipe stashes all m — folded onto the saved table's T axis
    stash = np.stack([np.maximum(np.minimum(pp - stage, eff_m), 1),
                      np.maximum(eff_m, 1)])              # (2, T)
    n_lm = tabs.transient.shape[0]
    n_r = tabs.saved.shape[0]
    T = tabs.transient.shape[1]
    sv = tabs.saved[None, :, :, :] * stash[:, None, None, :]
    out: dict = {}
    if profile is not None:
        sc = profile.scale_batch
        e = np.asarray(tabs.embed, I64)
        sv = sc(sv, "act_saved")
        # the act_transient rint group over (opt, off, t2)
        ctr = sc((tabs.transient + tabs.boundary + e)[:, None, None, :]
                 + tabs.opt_trans[:, :, :, None], "act_transient")
    if liveness and profile is None:
        aff = tabs.static_sum - tabs.outcopy[:, None, None, None]
        out["ocp"] = tabs.outcopy
        out["emb"] = np.asarray(tabs.embed, I64)
        out["tr"], out["bd"] = tabs.transient, tabs.boundary
        out["lss"], out["inp"] = tabs.loss, tabs.inputs
        out["cch"] = tabs.cache
        out["otr"] = np.ascontiguousarray(tabs.opt_trans).reshape(n_lm, -1)
    elif liveness:
        aff = tabs.static_scaled - tabs.outcopy_scaled[:, None, None, None]
        out["ocp"] = tabs.outcopy_scaled
        p1 = sc(e, "act_transient")
        p2 = sc(e + tabs.boundary, "act_transient")
        p3 = sc(e + tabs.boundary + tabs.transient, "act_transient")
        out["emb"], out["bd"], out["tr"] = p1, p2 - p1, p3 - p2
        out["ctr"] = np.ascontiguousarray(
            ctr - p3[:, None, None, :]).reshape(n_lm, -1)
        out["lss"] = sc(tabs.loss, "overhead")
        out["inp"] = sc(tabs.inputs, "overhead")
        out["cch"] = sc(tabs.cache, "overhead")
    elif profile is None:
        aff = tabs.static_sum + tabs.opt_trans[:, :, :, None]
        out["base"] = np.ascontiguousarray(
            tabs.transient + tabs.loss + tabs.inputs + tabs.cache
            + tabs.boundary + tabs.embed, dtype=I64)
    else:
        aff = tabs.static_scaled
        out["ctr"] = np.ascontiguousarray(ctr).reshape(n_lm, -1)
        out["base"] = np.ascontiguousarray(
            sc(tabs.loss, "overhead") + sc(tabs.inputs, "overhead")
            + sc(tabs.cache, "overhead"), dtype=I64)
    out["aff"] = np.ascontiguousarray(aff).reshape(n_lm, -1)
    # (2, n_r, n_lm, T) -> (n_lm, 2*n_r*T) with (gpipe, remat) leading
    out["b"] = np.ascontiguousarray(
        sv.transpose(2, 0, 1, 3)).reshape(n_lm, 2 * n_r * T)
    if tabs.pool is not None:
        pool, hit = tabs.pool, tabs.pool_saved
        drf = tabs.draft if tabs.draft is not None \
            else np.zeros_like(pool)
        if profile is not None:
            # the paged pool scales with the cache group, the draft
            # model's residency with the statics (profile.apply)
            pool, hit = sc(pool, "overhead"), sc(hit, "overhead")
            drf = sc(drf, "static")
        out["pool"], out["hit"], out["drf"] = pool, hit, drf
    if tabs.host_opt is not None:
        out["ho"] = np.ascontiguousarray(tabs.host_opt).reshape(n_lm, -1)
    return out


def tables_to_device(stacked: dict, device) -> dict:
    """Folded, stage-stacked numpy tables (the dict a ``_group_tables``
    returns — this package's or the reference package's) as int64 tensors
    on ``device``, ready for :func:`compose`."""
    device = torch.device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=I64)).to(device)
            for k, v in stacked.items()}


def _mesh_key(m: dict) -> tuple:
    return tuple(sorted(m.items()))


def _group_tables(engine, grid, cols, cfg, model, rows, rules, rep_ctx,
                  arch, env, opt_res, remat_eval, mesh_ids,
                  pp: int, jobs: int, drafts, device, stats: dict) -> dict:
    """Folded + stage-stacked DEVICE tables for one (arch, pipeline-degree)
    group, cached on the engine by everything that determines their values
    so repeated sweeps skip straight to the device composition.  Each
    stage's table build resolves its shard denominators with one batched
    ``shard_factor`` call on ``device``.  The grid's calibration profile
    is folded in on the host, and its hash keys the cache."""
    from repro_torch.calibrate.profile import profile_hash_of
    profile = grid.profile
    key = ("torch_tables", arch, grid.policy, cols.kind, cols.backend, pp,
           tuple(_mesh_key(cols.meshes[i]) for i in mesh_ids),
           opt_res, remat_eval, cols.offs, cols.serves, cols.pairs,
           cols.seqs, cols.mbs, profile_hash_of(profile), grid.assembly,
           str(device))
    cache = engine.__dict__.setdefault("_torch_table_cache", {})
    hit = cache.get(key)
    if hit is not None:
        stats["table_cache_hits"] += 1
        return hit
    t0 = time.perf_counter()
    plan = engine._stage_plan(arch, grid.policy, pp)
    folded = []
    for s, srows in enumerate(plan.stages):
        tabs, batch = SF.resolve_batched(functools.partial(
            B._stage_tables_jobs, cfg, model, list(srows), rules, rep_ctx,
            cols, env, profile, opt_res, remat_eval, mesh_ids, s, pp, jobs,
            drafts), device)
        stats["table_builds"] += 1
        stats["shard_factor_requests"] += len(batch)
        # a build whose every denominator is 1 asks for nothing: no launch
        stats["shard_factor_batches"] += bool(len(batch))
        folded.append(_fold_stage(
            tabs, env, pp, s, liveness=grid.assembly == "liveness",
            profile=profile))
    stacked = {k: np.stack([f[k] for f in folded]) for k in folded[0]}
    t1 = time.perf_counter()
    out = cache[key] = tables_to_device(stacked, device)
    stats["table_build_s"] += t1 - t0
    stats["upload_s"] += time.perf_counter() - t1
    return out


# ---------------------------------------------------------------------------
# the torch sweep entry point
# ---------------------------------------------------------------------------


def sweep_columnar_torch(engine, grid, jobs: int = 1,
                         device=None) -> "SW.SweepResults":
    """Drop-in twin of :func:`repro_torch.core.batch.sweep_columnar` running
    the per-cell composition on ``device`` (``cuda`` when None);
    byte-identical results, with or without a calibration profile.  A
    grid with a learned residual model is refused: its correction is
    applied per cell, on the numpy engine's cell path.  The phase split
    of the run (column lowering, host table build, upload, device
    composition, result copy, result finalizer, cache hits) is left on
    the engine as ``engine.last_sweep_stats``."""
    t0 = time.perf_counter()
    device = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    if grid.residual_model is not None:
        raise ValueError(
            "engine='torch' does not apply learned residual models; use "
            "engine='numpy' (the residual grid routes through the cell "
            "path)")
    grid.check_parallel()
    grid.check_serve()
    grid.check_offload()
    grid.check_assembly()
    live_mode = grid.assembly == "liveness"
    t_cols = time.perf_counter()
    cols = B.build_columns(grid)
    stats = {"device": str(device), "groups": 0, "table_cache_hits": 0,
             "table_builds": 0, "shard_factor_requests": 0,
             "shard_factor_batches": 0,
             "columns_s": time.perf_counter() - t_cols,
             "table_build_s": 0.0, "upload_s": 0.0, "compose_s": 0.0,
             "copy_s": 0.0, "finalize_s": 0.0}
    engine.last_sweep_stats = stats
    if cols.n == 0:
        return SW.SweepResults(grid=grid, results=[],
                               elapsed_s=time.perf_counter() - t0)
    profile = grid.profile
    n = cols.n
    n_pairs, n_seq = len(cols.pairs), len(cols.seqs)
    n_chip, n_mesh = len(cols.chips), len(cols.meshes)
    n_arch = len(cols.arches)
    n_off = len(cols.offs)
    block = n // n_arch
    inner = block // (n_chip * n_mesh)
    # inner-axis code columns: the first `inner` cells cycle every axis
    # right of the mesh axis once, and those codes repeat verbatim for
    # every (arch, chip, mesh) prefix — so the composition runs on the
    # (mesh, inner) domain and the result broadcasts over the chip axis
    o_i = cols.opt_c[:inner]
    f_i = cols.off_c[:inner]
    rm_i = cols.remat_c[:inner]
    mb_i = cols.mb_c[:inner]
    sv_i = cols.srv_c[:inner]
    pr_i = cols.pair_c[:inner]
    sq_i = cols.seq_c[:inner]
    accum_i = cols.accum[:inner]
    is_gpipe_sched = np.array([s == "gpipe" for s in cols.scheds], bool)
    gp_i = is_gpipe_sched[cols.sched_c[:inner]].astype(I64)
    t2_full_i = (mb_i * n_pairs + pr_i) * n_seq + sq_i
    t2_flat_i = pr_i * n_seq + sq_i
    t2_srv_i = (sv_i * n_pairs + pr_i) * n_seq + sq_i
    pp_of = np.array([int(m.get(PIPE_AXIS, 1)) for m in cols.meshes], I64)
    drafts = B._draft_states(engine, cols)
    off_grp = cols.kind == "train" and any(cols.offs)

    peak = np.zeros(n, I64)
    pool_arr = np.zeros(n, I64)
    draft_arr = np.zeros(n, I64)
    hit_arr = np.zeros(n, I64)
    off_arr = np.zeros(n, I64)
    slack_arr = np.zeros(n, I64) if live_mode else None
    opt_names: list = []
    remat_names: list = []
    opt_tbl: dict = {}
    remat_tbl: dict = {}
    res_opt_c = np.zeros(n, I64)
    res_remat_c = np.zeros(n, I64)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, I64)
                                        ).to(device)
    to_host = lambda t: t.cpu().numpy()
    from repro_torch.launch.mesh import arch_rules
    for ai, arch in enumerate(cols.arches):
        sl = slice(ai * block, (ai + 1) * block)
        cfg, model, rows = engine._arch_state(arch, grid.policy)
        rules = arch_rules(cfg, cols.kind)
        opt_res = tuple(o or cfg.optimizer for o in cols.opts)
        remat_res = tuple(r or cfg.remat for r in cols.remats)
        remat_eval = tuple(dict.fromkeys(remat_res))
        remat_idx = np.array([remat_eval.index(r) for r in remat_res],
                             I64)
        r_i = remat_idx[rm_i]
        n_r = len(remat_eval)
        rep_ctx = PL.make_context(
            cfg, dict(cols.meshes[0]), kind=cols.kind,
            global_batch=int(cols.gb[sl][0]), seq_len=int(cols.seq[sl][0]),
            backend=cols.backend)
        view = lambda a: a[sl].reshape(n_chip, n_mesh, inner)
        peak_v = view(peak)
        pool_v, draft_v, hit_v, off_v = (view(pool_arr), view(draft_arr),
                                         view(hit_arr), view(off_arr))
        slack_v = view(slack_arr) if live_mode else None
        for pp in sorted(set(pp_of.tolist())):
            mesh_ids = np.flatnonzero(pp_of == pp)
            env = B._knob_env(cfg, cols, pp)
            serve_grp = env["_serve_expanded"]
            t2 = (t2_full_i if env["_expanded"]
                  else t2_srv_i if serve_grp else t2_flat_i)
            T = len(env["mb"])
            cls_i = ((accum_i > 1) | (env["_eff_m"][t2] > 1)).astype(I64)
            tabs = _group_tables(engine, grid, cols, cfg, model, rows,
                                 rules, rep_ctx, arch, env, opt_res,
                                 remat_eval, mesh_ids, pp, jobs, drafts,
                                 device, stats)
            stats["groups"] += 1
            n_lm = len(mesh_ids)
            c_aff = (o_i * n_off + f_i) * 2 + cls_i
            c_b = (gp_i * n_r + r_i) * T + t2
            c_ctr = (o_i * n_off + f_i) * T + t2 if profile is not None \
                else np.zeros(0, I64)
            c_ho = o_i * n_off + f_i \
                if off_grp or (live_mode and profile is None) \
                else np.zeros(0, I64)
            sync()
            t1 = time.perf_counter()
            idx = tuple(to_dev(c) for c in (c_aff, c_b, c_ctr, c_ho, t2))
            best, bp, bd, bh, bo, bs = compose(
                tabs, idx, n_lm, inner, serve=bool(serve_grp),
                off=bool(off_grp), assembly=grid.assembly, kind=cols.kind)
            sync()
            t2_clock = time.perf_counter()
            peak_v[:, mesh_ids, :] = to_host(best)
            if serve_grp:
                pool_v[:, mesh_ids, :] = to_host(bp)
                draft_v[:, mesh_ids, :] = to_host(bd)
                hit_v[:, mesh_ids, :] = to_host(bh)
            if off_grp:
                off_v[:, mesh_ids, :] = to_host(bo)
            if live_mode:
                slack_v[:, mesh_ids, :] = to_host(bs)
            stats["compose_s"] += t2_clock - t1
            stats["copy_s"] += time.perf_counter() - t2_clock
        if profile is not None:
            # per-chip calibration offset on each chip's slice of the
            # broadcast stage max (the liveness slack is a difference of
            # two peaks, so the offset cancels there)
            chip_off = np.array([profile.chip_offset(c)
                                 for c in cols.chips], I64)
            peak_v += chip_off[:, None, None]
        per_opt = np.array([B._intern(opt_tbl, opt_names, o)
                            for o in opt_res], I64)
        res_opt_c[sl] = per_opt[cols.opt_c[sl]]
        per_remat = np.array([B._intern(remat_tbl, remat_names, r)
                              for r in remat_res], I64)
        res_remat_c[sl] = per_remat[cols.remat_c[sl]]
    t_fin = time.perf_counter()
    out = B._finalize_results(grid, cols, t0, peak, pool_arr, draft_arr,
                              hit_arr, off_arr, opt_names, remat_names,
                              res_opt_c, res_remat_c, slack_arr)
    stats["finalize_s"] = time.perf_counter() - t_fin
    return out
