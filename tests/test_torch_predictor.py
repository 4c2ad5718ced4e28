"""Scalar predictor of the port: ``planner.check`` reproduces the frozen
goldens (``tests/golden/<arch>.json``, ``raw`` variant) byte for byte and
equals the reference package's un-memoized ``planner.check`` cell for cell
on a pipeline / schedule / offload sample.  Integers: tolerance 0."""

import itertools
import json
import os

import pytest

from repro.configs import ShapeConfig as RShape
from repro.core import planner as RPL
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


@pytest.mark.parametrize("leg", sorted(LEGS))
@pytest.mark.parametrize("arch", SUPPORTED)
def test_check_reproduces_golden(arch, leg):
    with open(os.path.join(GOLDEN_DIR, f"{arch}.json")) as f:
        want = json.load(f)[leg]["raw"]
    kind, offload, assembly, extra = LEGS[leg]
    rep = PL.check(arch, ShapeConfig("golden", CANON_SEQ, CANON_BATCH, kind),
                   dict(CANON_MESH), backend=CANON_BACKEND, chip=CANON_CHIP,
                   offload_opt=offload, assembly=assembly)
    got = {c: int(getattr(rep.prediction, c)) for c in COMPONENTS + extra}
    got["per_module"] = {
        path: {k: (int(v) if k != "trainable" else bool(v))
               for k, v in m.items()}
        for path, m in rep.prediction.per_module.items()}
    assert set(got) == set(want)
    assert not first_divergence(want, got), first_divergence(want, got)
    assert rep.budget_bytes == int(RPL.chip_hbm(CANON_CHIP) * RPL.HEADROOM)


# the golden decode_paged leg is taken under a request mix (serve/fleet.py,
# not ported); an SSM keeps no paged KV, so the mix moves none of its bytes
# and the mix-free serve knobs reproduce the leg
PAGED_SERVE = dict(block_size=16, utilization=0.9, prefix_hit_rate=0.5,
                   prefix_len=256)


@pytest.mark.parametrize("arch", ["mamba2-1.3b"])
def test_check_reproduces_paged_golden_without_kv(arch):
    from repro_torch.serve.pool import ServeSpec
    with open(os.path.join(GOLDEN_DIR, f"{arch}.json")) as f:
        want = json.load(f)["decode_paged"]["raw"]
    rep = PL.check(arch, ShapeConfig("golden", CANON_SEQ, CANON_BATCH,
                                     "decode"),
                   dict(CANON_MESH), backend=CANON_BACKEND, chip=CANON_CHIP,
                   serve=ServeSpec.make(**PAGED_SERVE))
    got = {c: int(getattr(rep.prediction, c)) for c in COMPONENTS
           + ("pool_bytes", "hit_saved_bytes", "draft_bytes")}
    got["per_module"] = {
        path: {k: (int(v) if k != "trainable" else bool(v))
               for k, v in m.items()}
        for path, m in rep.prediction.per_module.items()}
    assert set(got) == set(want)
    assert not first_divergence(want, got), first_divergence(want, got)
    assert got["pool_bytes"] == 0


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
    with pytest.raises(NotImplementedError, match="not ported"):
        PL.check("llava15-7b", ShapeConfig("s", 1024, 8, "train"),
                 dict(CANON_MESH), profile=object())
    with pytest.raises(NotImplementedError, match="not ported"):
        PL.check("llava15-7b", ShapeConfig("s", 1024, 8, "train"),
                 dict(CANON_MESH), residual=object())
