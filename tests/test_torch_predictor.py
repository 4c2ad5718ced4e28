"""Scalar predictor of the port: ``planner.check`` reproduces the frozen
goldens (``tests/golden/<arch>.json``, the ``raw`` and the ``calibrated``
variant of every leg) byte for byte and equals the reference package's
un-memoized ``planner.check`` cell for cell on a pipeline / schedule /
offload sample, with and without calibration.  Integers: tolerance 0."""

import itertools
import json
import os

import pytest

from repro.configs import ShapeConfig as RShape
from repro.core import planner as RPL
from repro_torch.calibrate.profile import CalibrationProfile
from repro_torch.configs import ShapeConfig, registered_archs
from repro_torch.core import planner as PL

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
SUPPORTED = tuple(registered_archs())

# the canonical cell every snapshot is taken at
CANON_MESH = {"data": 2, "model": 2}
CANON_SEQ = 1024
CANON_BATCH = 8
CANON_CHIP = "v5e"
CANON_BACKEND = "tpu"
# the fixed non-identity profile of the goldens' calibrated variant
GOLDEN_PROFILE = CalibrationProfile(
    coefficients={"static": 1.0417, "act_saved": 0.9313,
                  "act_transient": 1.1902, "overhead": 0.8641},
    chip_constant_bytes={"v5e": 134217728, "*": 33554432})
VARIANTS = {"raw": None, "calibrated": GOLDEN_PROFILE}

COMPONENTS = ("param_bytes", "grad_bytes", "opt_bytes", "act_saved_bytes",
              "act_transient_bytes", "loss_bytes", "input_bytes",
              "cache_bytes", "output_copy_bytes", "calibration_bytes",
              "peak_bytes")
# leg -> (step kind, offload, assembly, extra frozen components)
LEGS = {
    "train": ("train", False, "legacy", ()),
    "prefill": ("prefill", False, "legacy", ()),
    "decode": ("decode", False, "legacy", ()),
    "train_offload": ("train", True, "legacy", ("offload_bytes",)),
    "train_liveness": ("train", False, "liveness",
                       ("overlap_slack_bytes",)),
}


def first_divergence(want: dict, got: dict, prefix: str = "") -> str:
    """Human-readable path of the first differing leaf ('' if equal)."""
    if want == got:
        return ""
    for key in list(want) + [k for k in got if k not in want]:
        w, g = want.get(key), got.get(key)
        here = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(w, dict) and isinstance(g, dict):
            sub = first_divergence(w, g, here)
            if sub:
                return sub
        elif w != g:
            return f"{here}: golden {w!r} != current {g!r}"
    return f"{prefix}: structural difference"


def _golden_of(prediction, variant, components):
    """The golden payload of one leg: the components, plus the per-module
    table on the raw variant (the calibrated variant freezes no table)."""
    got = {c: int(getattr(prediction, c)) for c in components}
    if variant == "raw":
        got["per_module"] = {
            path: {k: (int(v) if k != "trainable" else bool(v))
                   for k, v in m.items()}
            for path, m in prediction.per_module.items()}
    return got


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("leg", sorted(LEGS))
@pytest.mark.parametrize("arch", SUPPORTED)
def test_check_reproduces_golden(arch, leg, variant):
    with open(os.path.join(GOLDEN_DIR, f"{arch}.json")) as f:
        want = json.load(f)[leg][variant]
    kind, offload, assembly, extra = LEGS[leg]
    rep = PL.check(arch, ShapeConfig("golden", CANON_SEQ, CANON_BATCH, kind),
                   dict(CANON_MESH), backend=CANON_BACKEND, chip=CANON_CHIP,
                   offload_opt=offload, assembly=assembly,
                   profile=VARIANTS[variant])
    got = _golden_of(rep.prediction, variant, COMPONENTS + extra)
    assert set(got) == set(want)
    assert not first_divergence(want, got), first_divergence(want, got)
    assert rep.budget_bytes == int(RPL.chip_hbm(CANON_CHIP) * RPL.HEADROOM)


def canon_serve():
    """The ServeSpec of the golden decode_paged leg: 16-token blocks at
    0.9 pool utilization, 0.5 prefix-cache hit rate over a 256-token
    shared prefix, and a 25%-prefill request mix."""
    from repro_torch.serve.fleet import RequestMix
    from repro_torch.serve.pool import ServeSpec
    return ServeSpec.make(
        block_size=16, utilization=0.9, prefix_hit_rate=0.5,
        prefix_len=256,
        mix=RequestMix.make(0.25, ((512, 1), (CANON_SEQ, 3))))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", SUPPORTED)
def test_check_reproduces_paged_golden_without_kv(arch, variant):
    """The decode_paged leg under its request mix, raw and calibrated.  (An
    SSM keeps no paged KV, so its pool stays empty under the mix.)"""
    with open(os.path.join(GOLDEN_DIR, f"{arch}.json")) as f:
        want = json.load(f)["decode_paged"][variant]
    rep = PL.check(arch, ShapeConfig("golden", CANON_SEQ, CANON_BATCH,
                                     "decode"),
                   dict(CANON_MESH), backend=CANON_BACKEND, chip=CANON_CHIP,
                   serve=canon_serve(), profile=VARIANTS[variant])
    got = _golden_of(rep.prediction, variant, COMPONENTS
                     + ("pool_bytes", "hit_saved_bytes", "draft_bytes"))
    assert set(got) == set(want)
    assert not first_divergence(want, got), first_divergence(want, got)
    if arch == "mamba2-1.3b":
        assert got["pool_bytes"] == 0
    else:
        assert got["pool_bytes"] > 0


def _sample():
    meshes = ({"data": 2, "model": 2, "pipe": 2},
              {"data": 1, "model": 4, "pipe": 4},
              {"data": 8, "model": 1})
    for arch, mesh, sched, off, asm in itertools.product(
            ("llava15-7b", "llama3.2-3b"), meshes, ("1f1b", "gpipe"),
            (False, True), ("legacy", "liveness")):
        yield pytest.param(
            arch, mesh, sched, off, asm,
            id=f"{arch}-{'x'.join(map(str, mesh.values()))}-{sched}-"
               f"{'offload' if off else 'resident'}-{asm}")


@pytest.mark.parametrize("arch,mesh,sched,off,asm", list(_sample()))
def test_check_equals_reference_on_pipeline_sample(arch, mesh, sched, off,
                                                   asm):
    kw = dict(backend="tpu", grad_accum=2, remat="dots",
              optimizer="adamw8bit", chip="h100", microbatches=4,
              schedule=sched, offload_opt=off, assembly=asm)
    ref = RPL.check(arch, RShape("s", 2048, 32, "train"), dict(mesh), **kw)
    got = PL.check(arch, ShapeConfig("s", 2048, 32, "train"), dict(mesh),
                   **kw)
    for c in COMPONENTS + ("offload_bytes", "overlap_slack_bytes"):
        assert getattr(got.prediction, c) == getattr(ref.prediction, c), c
    assert (got.peak_bytes, got.budget_bytes, got.fits) \
        == (ref.peak_bytes, ref.budget_bytes, ref.fits)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_check_equals_reference_on_serve_kinds(kind, backend):
    from repro.serve.pool import ServeSpec as RServe
    from repro_torch.serve.pool import ServeSpec
    knobs = dict(block_size=16, utilization=0.9, prefix_hit_rate=0.5,
                 prefix_len=256)
    for arch in ("llava15-7b", "smollm-360m"):
        ref = RPL.check(arch, RShape("s", 2048, 8, kind),
                        {"data": 2, "model": 4}, backend=backend,
                        serve=RServe.make(**knobs))
        got = PL.check(arch, ShapeConfig("s", 2048, 8, kind),
                       {"data": 2, "model": 4}, backend=backend,
                       serve=ServeSpec.make(**knobs))
        for c in COMPONENTS + ("pool_bytes", "hit_saved_bytes"):
            assert getattr(got.prediction, c) == getattr(ref.prediction, c)


def test_check_rejects_calibration():
    """Calibration, refused by earlier slices, now equals the reference:
    ``check`` under a profile, and under a profile plus a learned residual
    model; a residual fitted over another profile is refused as the
    reference refuses it."""
    from repro.calibrate import learned as RL
    from repro.calibrate.profile import CalibrationProfile as RProfile
    from repro_torch.calibrate import learned as TL
    rprof = RProfile(coefficients=dict(GOLDEN_PROFILE.coefficients),
                     chip_constant_bytes=dict(
                         GOLDEN_PROFILE.chip_constant_bytes))
    w = [0.01 * (i % 4) for i in range(len(TL.FEATURE_NAMES))]
    d = {"schema_version": 1, "kind": "residual_model",
         "features": list(TL.FEATURE_NAMES), "families": {"vlm": w},
         "global": None, "base_profile_hash": GOLDEN_PROFILE.profile_hash,
         "created": "", "source": {}, "fit": {}}
    res, rres = TL.ResidualModel.from_dict(d), RL.ResidualModel.from_dict(d)
    for mesh in (dict(CANON_MESH), {"data": 2, "model": 2, "pipe": 2}):
        for kw, rkw in ((dict(profile=GOLDEN_PROFILE), dict(profile=rprof)),
                        (dict(profile=GOLDEN_PROFILE, residual=res),
                         dict(profile=rprof, residual=rres))):
            got = PL.check("llava15-7b", ShapeConfig("s", 1024, 8, "train"),
                           dict(mesh), chip="h100", **kw)
            ref = RPL.check("llava15-7b", RShape("s", 1024, 8, "train"),
                            dict(mesh), chip="h100", **rkw)
            for c in COMPONENTS + ("residual_bytes",):
                assert getattr(got.prediction, c) \
                    == getattr(ref.prediction, c), c
            assert (got.peak_bytes, got.fits) == (ref.peak_bytes, ref.fits)
        assert got.prediction.residual_bytes != 0
        assert got.prediction.calibration_bytes == 33554432
    with pytest.raises(ValueError, match="fitted over profile"):
        PL.check("llava15-7b", ShapeConfig("s", 1024, 8, "train"),
                 dict(CANON_MESH), residual=res)
