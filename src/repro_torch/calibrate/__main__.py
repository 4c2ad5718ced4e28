"""Calibration CLI: fit | fit-residual | apply | report.

    # fit a profile from measurements (dry-run artifacts, a saved store,
    # or the deterministic synthetic set) and save it
    python -m repro_torch.calibrate fit --synthetic --out profile.json
    python -m repro_torch.calibrate fit --dryrun-dir experiments/dryrun \
        --out profile.json
    python -m repro_torch.calibrate fit --measurements store.json --out p.json

    # fit the learned per-family residual model on top of that profile
    python -m repro_torch.calibrate fit-residual --synthetic \
        --profile profile.json --out residual.json

    # calibrated vs raw prediction for one cell
    python -m repro_torch.calibrate apply --profile profile.json \
        --arch llava15-7b --shape train_4k --mesh data=8,model=2 --chip v5e

    # the paper-style accuracy table (per-arch/family MAPE, cal vs raw)
    python -m repro_torch.calibrate report --profile profile.json --synthetic \
        --by family --md report.md --json report.json
"""

from __future__ import annotations

import argparse
import datetime
import sys
from typing import Optional, Sequence

GiB = 1024 ** 3


def _load_store(args) -> "object":
    from repro_torch.calibrate.measurements import MeasurementStore
    if args.synthetic:
        from repro_torch.calibrate.synthetic import generate
        return generate(noise=args.noise)
    if args.measurements:
        return MeasurementStore.load(args.measurements)
    store = MeasurementStore.ingest_dryrun_dir(args.dryrun_dir)
    if not len(store):
        raise SystemExit(
            f"no measurements: dry-run dir "
            f"{args.dryrun_dir or 'experiments/dryrun'} is empty — run "
            f"the dry-run harness, pass --measurements, or use --synthetic")
    return store


def _add_source_args(p) -> None:
    p.add_argument("--measurements", metavar="PATH",
                   help="saved MeasurementStore JSON")
    p.add_argument("--dryrun-dir", metavar="DIR", default=None,
                   help="dry-run artifact dir (default: experiments/dryrun)")
    p.add_argument("--synthetic", action="store_true",
                   help="use the deterministic synthetic measurement set")
    p.add_argument("--noise", type=float, default=0.01,
                   help="synthetic relative noise amplitude")


def cmd_fit(args) -> int:
    from repro_torch.calibrate.fit import fit_profile
    store = _load_store(args)
    created = datetime.datetime.now(datetime.timezone.utc) \
        .strftime("%Y-%m-%dT%H:%M:%SZ")
    profile = fit_profile(
        store, created=created,
        source={"cli": "fit",
                "input": ("synthetic" if args.synthetic
                          else args.measurements or "dryrun")})
    path = profile.save(args.out)
    print(profile.summary())
    print(f"fitted from {len(store)} measurements "
          f"({', '.join(store.archs())})")
    print(f"wrote {path}")
    return 0


def cmd_fit_residual(args) -> int:
    from repro_torch.calibrate.learned import fit_residual
    from repro_torch.calibrate.profile import CalibrationProfile
    profile = CalibrationProfile.load(args.profile) if args.profile \
        else None
    store = _load_store(args)
    created = datetime.datetime.now(datetime.timezone.utc) \
        .strftime("%Y-%m-%dT%H:%M:%SZ")
    model = fit_residual(
        store, profile=profile, lam=args.lam, created=created,
        source={"cli": "fit-residual",
                "input": ("synthetic" if args.synthetic
                          else args.measurements or "dryrun")})
    path = model.save(args.out)
    print(model.summary())
    info = model.fit_info
    print(f"in-sample MAPE: affine {info['mape_affine_pct']:.2f}% -> "
          f"learned {info['mape_learned_pct']:.2f}% "
          f"({len(store)} measurements)")
    print(f"wrote {path}")
    return 0


def _load_residual(args, profile):
    """--residual-model loader shared by apply/report; validates the
    base-profile binding before any prediction runs."""
    if not getattr(args, "residual_model", None):
        return None
    from repro_torch.calibrate.learned import ResidualModel
    model = ResidualModel.load(args.residual_model)
    phash = profile.profile_hash if profile is not None else None
    if model.base_profile_hash != phash:
        raise SystemExit(
            f"--residual-model was fitted over profile "
            f"{model.base_profile_hash or 'raw'}, not "
            f"{phash or 'raw'}; pass the matching --profile")
    return model


def cmd_apply(args) -> int:
    from repro_torch.calibrate.profile import CalibrationProfile
    from repro_torch.core import planner
    from repro_torch.core.sweep import _parse_mesh, normalize_arch
    profile = CalibrationProfile.load(args.profile)
    residual = _load_residual(args, profile)
    arch = normalize_arch(args.arch)
    mesh = _parse_mesh(args.mesh)
    raw = planner.check(arch, args.shape, mesh, backend=args.backend,
                        chip=args.chip)
    cal = planner.check(arch, args.shape, mesh, backend=args.backend,
                        chip=args.chip, profile=profile,
                        residual=residual)
    print(profile.summary())
    if residual is not None:
        print(residual.summary())
    print(f"raw : {raw}")
    print(f"cal : {cal}")
    delta = cal.peak_bytes - raw.peak_bytes
    print(f"delta: {delta / GiB:+.3f} GiB "
          f"({100.0 * delta / max(raw.peak_bytes, 1):+.2f}%)")
    return 0


def cmd_report(args) -> int:
    from repro_torch.calibrate.profile import CalibrationProfile
    from repro_torch.calibrate.report import evaluate
    profile = CalibrationProfile.load(args.profile)
    residual = _load_residual(args, profile)
    store = _load_store(args)
    rep = evaluate(store, profile, by=args.by, residual=residual)
    md = rep.to_markdown()
    print(md)
    if args.md:
        with open(args.md, "w") as f:
            f.write(md + "\n")
        print(f"wrote {args.md}")
    if args.json:
        rep.save_json(args.json)
        print(f"wrote {args.json}")
    return 0 if rep.mape_calibrated <= rep.mape_raw else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.calibrate",
        description="Fit/apply/evaluate measurement-driven calibration "
                    "profiles for the memory predictor.")
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fit", help="fit a CalibrationProfile (NNLS)")
    _add_source_args(f)
    f.add_argument("--out", required=True, metavar="PATH",
                   help="profile JSON output path")
    f.set_defaults(fn=cmd_fit)

    fr = sub.add_parser(
        "fit-residual",
        help="fit a learned per-family ResidualModel (ridge) on top of "
             "a profile")
    _add_source_args(fr)
    fr.add_argument("--profile", default=None, metavar="PATH",
                    help="CalibrationProfile the residual is fitted on "
                         "top of (omit to fit the raw-prediction "
                         "residual)")
    fr.add_argument("--lam", type=float, default=1e-3,
                    help="ridge regularization strength")
    fr.add_argument("--out", required=True, metavar="PATH",
                    help="residual model JSON output path")
    fr.set_defaults(fn=cmd_fit_residual)

    a = sub.add_parser("apply",
                       help="calibrated vs raw prediction for one cell")
    a.add_argument("--profile", required=True)
    a.add_argument("--residual-model", default=None, metavar="PATH",
                   help="learned ResidualModel JSON applied on top of "
                        "--profile")
    a.add_argument("--arch", required=True)
    a.add_argument("--shape", default="train_4k")
    a.add_argument("--mesh", default="data=16,model=16",
                   metavar="data=16,model=16")
    a.add_argument("--chip", default="v5e")
    a.add_argument("--backend", default="tpu", choices=("tpu", "cpu"))
    a.set_defaults(fn=cmd_apply)

    r = sub.add_parser("report",
                       help="per-group MAPE table, calibrated vs raw")
    r.add_argument("--profile", required=True)
    r.add_argument("--residual-model", default=None, metavar="PATH",
                   help="learned ResidualModel JSON; adds a third "
                        "(learned) MAPE series")
    _add_source_args(r)
    r.add_argument("--by", default="family", choices=("family", "arch"))
    r.add_argument("--md", metavar="PATH", help="write markdown report")
    r.add_argument("--json", metavar="PATH", help="write JSON report")
    r.set_defaults(fn=cmd_report)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
