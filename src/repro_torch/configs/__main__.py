"""Print the registered-architecture table (markdown).

    PYTHONPATH=src python -m repro_torch.configs
    PYTHONPATH=src python -m repro_torch.configs --profile profile.json \
        --chip v5e --mesh data=16,model=16 --shape train_4k
    PYTHONPATH=src python -m repro_torch.configs --breakdown --arch llava15_7b \
        --mesh data=4,model=2,pipe=2 --microbatches 4

docs/configs.md embeds the plain output; re-run after registering a new
arch.  With ``--profile`` (a fitted repro_torch.calibrate CalibrationProfile)
two extra columns show each architecture's predicted peak on the
reference cell, raw and calibrated.  With ``--breakdown`` one
architecture's prediction is decomposed into the per-module memory table
(``PredictedMemory.per_module``) and — when the mesh has a ``pipe``
axis — the per-pipeline-stage table (``predictor.predict_stages``);
a mesh with an ``expert`` / ``context`` axis adds per-expert-shard and
per-context-shard columns (``ep_saved`` / ``cp_saved``: what each module
saves versus the same cell with that axis stripped).
"""

from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.configs import get_config, registered_archs

GiB = 1024 ** 3


def _attention_kind(cfg) -> str:
    if cfg.mla:
        return "MLA"
    if cfg.family == "ssm":
        return "SSM (mamba2)"
    if cfg.family == "hybrid":
        return "SSM + shared attn"
    base = "GQA" if cfg.n_kv_heads < cfg.n_heads else "MHA"
    if cfg.family == "encdec":
        return f"{base} + cross"
    return base


def _modality(cfg) -> str:
    return {"vlm": "vision+text", "encdec": "audio+text"}.get(
        cfg.family, "text")


def _params(cfg) -> str:
    from repro_torch.core.parser import parse_model, total_params
    from repro_torch.core.spec import FULL_TRAIN
    from repro_torch.models import build_model
    n = total_params(parse_model(build_model(cfg).spec, FULL_TRAIN))
    return f"{n / 1e9:.2f}B" if n >= 1e9 else f"{n / 1e6:.0f}M"


def table(profile=None, chip: str = "v5e",
          mesh: Optional[dict] = None, shape: str = "train_4k",
          residual=None) -> str:
    """The arch table; with a CalibrationProfile, adds raw + calibrated
    predicted-peak columns for the reference (shape, mesh, chip) cell
    (plus a learned column when a ResidualModel is given)."""
    from repro_torch.core.report import markdown_table
    headers = ["arch", "family", "params", "modality", "attention",
               "optimizer", "remat", "fsdp"]
    engine = None
    if profile is not None:
        from repro_torch.core import sweep as SW
        engine = SW.SweepEngine()
        mesh = mesh or {"data": 16, "model": 16}
        headers += [f"peak GiB ({shape})", "calibrated GiB"]
        if residual is not None:
            headers += ["learned GiB"]
    rows = []
    for name in registered_archs():
        cfg = get_config(name)
        row = [name, cfg.family, _params(cfg), _modality(cfg),
               _attention_kind(cfg), cfg.optimizer, cfg.remat,
               "yes" if cfg.fsdp else "no"]
        if profile is not None:
            from repro_torch.core import planner as PL
            budget = int(PL.chip_hbm(chip) * PL.HEADROOM)
            raw = engine.report(name, shape, mesh, budget_bytes=budget,
                                chip=chip)
            cal = engine.report(name, shape, mesh, budget_bytes=budget,
                                chip=chip, profile=profile)
            row += [f"{raw.peak_bytes / GiB:.2f}",
                    f"{cal.peak_bytes / GiB:.2f}"]
            if residual is not None:
                lrn = engine.report(name, shape, mesh,
                                    budget_bytes=budget, chip=chip,
                                    profile=profile, residual=residual)
                row += [f"{lrn.peak_bytes / GiB:.2f}"]
        rows.append(tuple(row))
    return markdown_table(headers, rows)


def breakdown(arch: str, shape: str = "train_4k",
              mesh: Optional[dict] = None, chip: str = "v5e",
              policy: str = "full", backend: str = "tpu",
              microbatches: int = 1, schedule: str = "1f1b",
              serve=None, assembly: str = "legacy") -> str:
    """Per-module (and, with a ``pipe`` mesh axis, per-stage) memory
    breakdown of one architecture's prediction on a reference cell.
    ``serve`` (a repro_torch.serve.pool.ServeSpec, serve kinds only) adds the
    paged-KV pool / prefix-savings / draft-residency summary line.
    ``assembly="liveness"`` reports the interval-overlap peak and adds
    the reporting-only overlap-slack column (legacy minus liveness)."""
    from repro_torch.configs import get_config
    from repro_torch.core import planner as PL
    from repro_torch.core import predictor as PR
    from repro_torch.core.report import markdown_table
    from repro_torch.core.sweep import POLICIES, normalize_arch
    from repro_torch.models import build_model

    from repro_torch.launch.mesh import cp_degree, ep_degree

    arch = normalize_arch(arch)
    cfg = get_config(arch)
    model = build_model(cfg)
    shp = PL._resolve_shape(shape)
    mesh = mesh or {"data": 16, "model": 16}
    ctx = PL.make_context(cfg, mesh, kind=shp.kind,
                          global_batch=shp.global_batch,
                          seq_len=shp.seq_len, backend=backend,
                          microbatches=microbatches, schedule=schedule,
                          serve=serve)
    preds = PR.predict_stages(model, POLICIES[policy], ctx,
                              assembly=assembly)
    peak_stage = max(range(len(preds)),
                     key=lambda i: preds[i].peak_bytes)
    pred = preds[peak_stage]
    budget = PL.chip_hbm(chip) * PL.HEADROOM
    mesh_str = ",".join(f"{k}={v}" for k, v in sorted(mesh.items()))
    gib = lambda v: f"{v / GiB:.3f}"
    live = assembly == "liveness"
    out = [f"## {arch} {shp.name} on {mesh_str} ({backend} prediction"
           + (", liveness assembly)" if live else ")"),
           "",
           f"peak {pred.peak_bytes / GiB:.2f} GiB vs "
           f"{budget / GiB:.2f} GiB budget ({chip}) -> "
           f"{'FITS' if pred.peak_bytes <= budget else 'OOM'}", ""]
    if live:
        out += [f"overlap slack {gib(pred.overlap_slack_bytes)} GiB "
                f"(legacy sum-of-maxima would report "
                f"{(pred.peak_bytes + pred.overlap_slack_bytes) / GiB:.2f}"
                f" GiB)", ""]

    # serving-fleet summary (decode/prefill cells with active serve
    # knobs): the paged pool replaces the slen-growing cache terms, so
    # its line sits next to the peak it feeds instead of being dropped
    if ctx.serve is not None and (pred.pool_bytes or pred.draft_bytes
                                  or pred.hit_saved_bytes):
        from repro_torch.serve.pool import pool_blocks
        s = ctx.serve
        line = (f"serving: block {s.block_size} "
                f"({pool_blocks(shp.seq_len, s)} blocks/seq), "
                f"util {s.util_bp / 10000:.2f}, "
                f"hit {s.hit_bp / 10000:.2f} -> "
                f"kv_pool {gib(pred.pool_bytes)} GiB "
                f"(prefix hits save {gib(pred.hit_saved_bytes)} GiB)")
        if s.draft_arch:
            line += (f"; draft {s.draft_arch} "
                     f"{gib(pred.draft_bytes)} GiB resident")
        out += [line, ""]

    # per-expert-shard / per-context-shard columns: re-predict the SAME
    # cell with the expert (resp. context) axis stripped; each module's
    # delta is what that axis saves it on the peak stage.  The stage
    # partition depends only on the pipe degree, so stage indices line
    # up between the stripped and full meshes.
    ep, cp = ep_degree(mesh), cp_degree(mesh)

    def _without(axis):
        m = {k: v for k, v in mesh.items() if k != axis}
        c = PL.make_context(cfg, m, kind=shp.kind,
                            global_batch=shp.global_batch,
                            seq_len=shp.seq_len, backend=backend,
                            microbatches=microbatches, schedule=schedule)
        return PR.predict_stages(model, POLICIES[policy], c)[peak_stage]

    mod_total = lambda m: m["param"] + m["grad"] + m["opt"] + m["act"]
    ep_saved = cp_saved = None
    if ep > 1:
        ep_saved = {path: mod_total(m) - mod_total(pred.per_module[path])
                    for path, m in _without("expert").per_module.items()}
    if cp > 1:
        cp_saved = {path: mod_total(m) - mod_total(pred.per_module[path])
                    for path, m in _without("context").per_module.items()}
    if ep > 1 or cp > 1:
        out.append(f"expert-parallel ep={ep} (MoE weights + dispatch "
                   f"buffers / {ep}) x context-parallel cp={cp} (seq "
                   f"activations + ring KV blocks / {cp})")
        out.append("")
    if len(preds) > 1:
        from repro_torch.core import stages as ST
        rows = []
        for i, p in enumerate(preds):
            stash = ST.stash_count(i, ctx.pp, ctx.eff_microbatches,
                                   ctx.schedule)
            row = (i, len(p.per_module), stash,
                   gib(p.param_bytes),
                   gib(p.grad_bytes + p.opt_bytes),
                   gib(p.act_saved_bytes),
                   gib(p.act_transient_bytes),
                   gib(p.loss_bytes + p.input_bytes
                       + p.cache_bytes))
            if live:
                row += (gib(p.overlap_slack_bytes),)
            rows.append(row + (gib(p.peak_bytes),
                               "<- peak" if i == peak_stage else ""))
        stage_headers = ("stage", "modules", "stash", "param", "grad+opt",
                         "act_saved", "act_trans", "overheads")
        if live:
            stage_headers += ("ovl_slack",)
        out.append(markdown_table(
            stage_headers + ("peak_gib", ""),
            rows,
            title=f"pipeline stages (pp={ctx.pp} x {microbatches} "
                  f"microbatches, {schedule})"))
        out.append("")
    mod_rows = []
    for path, m in pred.per_module.items():
        total = m["param"] + m["grad"] + m["opt"] + m["act"]
        row = [path, "yes" if m["trainable"] else "frozen",
               gib(m["param"]), gib(m["grad"]), gib(m["opt"]),
               gib(m["act"]), gib(total)]
        if ep_saved is not None:
            row.append(gib(ep_saved[path]))
        if cp_saved is not None:
            row.append(gib(cp_saved[path]))
        mod_rows.append(tuple(row))
    headers = ["module", "trainable", "param", "grad", "opt", "act_saved",
               "total_gib"]
    if ep_saved is not None:
        headers.append(f"ep_saved (x{ep})")
    if cp_saved is not None:
        headers.append(f"cp_saved (x{cp})")
    title = ("per-module breakdown"
             + (f" (peak stage {peak_stage})" if len(preds) > 1 else ""))
    out.append(markdown_table(tuple(headers), mod_rows, title=title))
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.configs")
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="CalibrationProfile JSON: adds raw + calibrated "
                         "predicted-peak columns")
    ap.add_argument("--residual-model", metavar="PATH", default=None,
                    help="learned ResidualModel JSON (needs --profile it "
                         "was fitted over): adds a learned predicted-"
                         "peak column")
    ap.add_argument("--breakdown", action="store_true",
                    help="print one arch's per-module / per-stage memory "
                         "table for the reference cell (needs --arch)")
    ap.add_argument("--arch", default=None,
                    help="architecture for --breakdown")
    ap.add_argument("--policy", default="full",
                    help="train policy for --breakdown "
                         "(full/llava_stage1/llava_stage2)")
    ap.add_argument("--backend", default="tpu", choices=("tpu", "cpu"),
                    help="prediction backend for --breakdown")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="pipeline microbatch count for --breakdown "
                         "(with a pipe mesh axis)")
    ap.add_argument("--schedule", default="1f1b",
                    choices=("1f1b", "gpipe"),
                    help="pipeline schedule for --breakdown")
    ap.add_argument("--assembly", default="legacy",
                    choices=("legacy", "liveness"),
                    help="peak assembly for --breakdown: legacy "
                         "sum-of-maxima or liveness interval-overlap "
                         "(adds the overlap-slack column)")
    ap.add_argument("--block-size", type=int, default=0,
                    help="paged-KV block size in tokens for --breakdown "
                         "(serve kinds; 0 = contiguous)")
    ap.add_argument("--utilization", type=float, default=1.0,
                    help="KV pool utilization in (0,1] for --breakdown")
    ap.add_argument("--prefix-hit-rate", type=float, default=0.0,
                    help="prefix-cache hit rate in [0,1] for --breakdown")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="shared-prefix token count for --breakdown")
    ap.add_argument("--mix", default=None, metavar="P[:LxW,...]",
                    help="request mix for --breakdown (prefill fraction "
                         "+ seq-len histogram, e.g. 0.3:512x1,4096x3)")
    ap.add_argument("--draft-arch", default="",
                    help="speculative-decode draft arch for --breakdown "
                         "(decode kind only)")
    ap.add_argument("--chip", default=None,
                    help="reference chip (default v5e)")
    ap.add_argument("--mesh", default=None, metavar="data=16,model=16",
                    help="reference mesh (may include pipe=N)")
    ap.add_argument("--shape", default=None,
                    help="reference shape (default train_4k)")
    args = ap.parse_args(argv)
    serve_given = bool(args.block_size or args.utilization != 1.0
                       or args.prefix_hit_rate or args.prefix_len
                       or args.mix or args.draft_arch)
    if serve_given and not args.breakdown:
        ap.error("--block-size/--utilization/--prefix-hit-rate/"
                 "--prefix-len/--mix/--draft-arch only apply to "
                 "--breakdown")
    if args.assembly != "legacy" and not args.breakdown:
        ap.error("--assembly only applies to --breakdown")
    if args.breakdown:
        if args.profile:
            ap.error("--breakdown and --profile are mutually exclusive")
        if not args.arch:
            ap.error("--breakdown needs --arch")
        from repro_torch.core import planner as PL
        from repro_torch.core.sweep import POLICIES, _parse_mesh
        try:
            mesh = _parse_mesh(args.mesh) if args.mesh else None
            chip = args.chip or "v5e"
            PL.chip_hbm(chip)
            if args.policy not in POLICIES:
                raise ValueError(f"unknown policy {args.policy!r}; "
                                 f"known: {sorted(POLICIES)}")
            serve = None
            if serve_given:
                from repro_torch.serve.fleet import parse_mix
                from repro_torch.serve.pool import ServeSpec
                serve = ServeSpec.make(
                    block_size=args.block_size,
                    utilization=args.utilization,
                    prefix_hit_rate=args.prefix_hit_rate,
                    prefix_len=args.prefix_len,
                    mix=parse_mix(args.mix) if args.mix else None,
                    draft_arch=args.draft_arch)
            print(breakdown(args.arch, shape=args.shape or "train_4k",
                            mesh=mesh, chip=chip, policy=args.policy,
                            backend=args.backend,
                            microbatches=args.microbatches,
                            schedule=args.schedule, serve=serve,
                            assembly=args.assembly))
        except (KeyError, ValueError) as e:
            ap.error(str(e))
        return 0
    if args.profile is None:
        if args.residual_model:
            ap.error("--residual-model needs the --profile it was "
                     "fitted over")
        given = [f for f in ("chip", "mesh", "shape")
                 if getattr(args, f) is not None]
        if given:
            ap.error(f"--{'/--'.join(given)} only apply to the "
                     f"--profile reference cell or --breakdown")
        print(table())
        return 0
    from repro_torch.calibrate.profile import CalibrationProfile
    from repro_torch.configs import SHAPES
    from repro_torch.core import planner as PL
    from repro_torch.core.sweep import _parse_mesh
    chip = args.chip or "v5e"
    shape = args.shape or "train_4k"
    mesh_str = args.mesh or "data=16,model=16"
    residual = None
    try:
        profile = CalibrationProfile.load(args.profile)
        if args.residual_model:
            from repro_torch.calibrate.learned import ResidualModel
            residual = ResidualModel.load(args.residual_model)
            if residual.base_profile_hash != profile.profile_hash:
                raise ValueError(
                    f"--residual-model was fitted over profile "
                    f"{residual.base_profile_hash or 'raw'}, not "
                    f"{profile.profile_hash}; pass the matching "
                    f"--profile")
        mesh = _parse_mesh(mesh_str)
        PL.chip_hbm(chip)
        if shape not in SHAPES:
            raise ValueError(f"unknown shape {shape!r}; "
                             f"known: {sorted(SHAPES)}")
    except (OSError, KeyError, ValueError) as e:
        ap.error(str(e))
    print(f"_profile {profile.profile_hash}"
          + (f" + residual {residual.model_hash}" if residual else "")
          + f": reference cell {shape} on {mesh_str} ({chip})_\n")
    print(table(profile=profile, chip=chip, mesh=mesh, shape=shape,
                residual=residual))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
