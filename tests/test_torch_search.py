"""Branch-and-bound planner queries of the port (``core/search.py``,
``planner.plan*``) against the reference package: pruned searches return
the exhaustive answer (same cell, same tie-break) and the reference's, on
the torch engine (``device="cpu"``) and the host numpy engine; the bounds
they prune with are sound on full sweeps.  The user-facing queries of the
MoE / MLA / enc-dec / hybrid archs reproduce the reference's answers.
Integers: tolerance 0."""

import dataclasses

import numpy as np
import pytest

from repro.configs import ShapeConfig as RShape
from repro.core import planner as RPL
from repro.core import search as RSR
from repro.core import spec as RS
from repro.core import sweep as RSW
from repro_torch.configs import ShapeConfig
from repro_torch.core import planner as PL
from repro_torch.core import search as SR
from repro_torch.core import sweep as SW
from repro_torch.core.spec import FULL_TRAIN

ENGINES = [("torch", {"device": "cpu"}), ("numpy", {})]
CELL_FIELDS = ("arch", "chip", "n_chips", "mesh_shape", "optimizer",
               "remat", "schedule", "microbatches", "grad_accum",
               "global_batch", "seq_len", "peak_bytes", "fits")


@pytest.fixture(scope="module")
def eng():
    return SW.SweepEngine()


@pytest.fixture(scope="module")
def ref_eng():
    return RSW.SweepEngine()


def cell_of(r) -> tuple:
    return None if r is None else tuple(getattr(r, f) for f in CELL_FIELDS)


def shapes(seq, gb, kind):
    return ShapeConfig("q", seq, gb, kind), RShape("q", seq, gb, kind)


GOLDEN = dict(coefficients={"static": 1.0417, "act_saved": 0.9313,
                            "act_transient": 1.1902, "overhead": 0.8641},
              chip_constant_bytes={"v5e": 134217728, "*": 33554432})


def profiles(**kw):
    """The same CalibrationProfile in the port and in the reference."""
    from repro.calibrate.profile import CalibrationProfile as RProfile
    from repro_torch.calibrate.profile import CalibrationProfile
    kw = {**GOLDEN, **kw}
    return CalibrationProfile(**kw), RProfile(**kw)


def residuals(prof, rprof):
    """A fixed learned residual model over each side's profile."""
    from repro.calibrate import learned as RL
    from repro_torch.calibrate import learned as TL
    w = [0.02 * ((i % 3) - 1) for i in range(len(TL.FEATURE_NAMES))]
    d = {"schema_version": 1, "kind": "residual_model",
         "features": list(TL.FEATURE_NAMES), "families": {},
         "global": w, "created": "", "source": {}, "fit": {}}
    return (TL.ResidualModel.from_dict(
                dict(d, base_profile_hash=prof.profile_hash)),
            RL.ResidualModel.from_dict(
                dict(d, base_profile_hash=rprof.profile_hash)))


def serve_specs(**kw):
    """The same ServeSpec (a request mix parsed from ``mix``) in both."""
    from repro.serve.fleet import parse_mix as rparse
    from repro.serve.pool import ServeSpec as RServe
    from repro_torch.serve.fleet import parse_mix
    from repro_torch.serve.pool import ServeSpec
    mix = kw.pop("mix", "")
    return (ServeSpec.make(mix=parse_mix(mix), **kw),
            RServe.make(mix=rparse(mix), **kw))


# ---------------------------------------------------------------------------
# statics floor soundness
# ---------------------------------------------------------------------------


FLOOR_GRIDS = [
    dict(arch="llama3.2-3b", kind="train",
         optimizers=("adamw", "adafactor", "adamw8bit"),
         offload_optimizer=(False, True)),
    dict(arch="llama3.1-8b", kind="train"),
    dict(arch="deepseek-v2-lite-16b", kind="train"),
    dict(arch="llava15-7b", kind="train"),
    dict(arch="llama3.2-3b", kind="decode"),
]


@pytest.mark.parametrize("kw", FLOOR_GRIDS,
                         ids=[f"{g['arch']}-{g['kind']}"
                              for g in FLOOR_GRIDS])
def test_floor_never_exceeds_any_peak(eng, kw):
    """floor // n_chips <= peak for EVERY cell of a full sweep, and the
    floor is the reference's."""
    common = dict(chips=(8, 16), chip="v5e", global_batches=(8, 16),
                  seq_lens=(2048,), microbatches=(1, 2), **kw)
    grid = SW.SweepGrid(**common)
    floor = SR._floor_for(grid)
    assert floor > 0
    assert floor == RSR._floor_for(RSW.SweepGrid(**common))
    res = eng.sweep(grid, engine="torch", device="cpu")
    assert len(res) > 0
    bound = floor // res.columns.n_chips
    assert int((res.columns.peak_bytes < bound).sum()) == 0


def test_floor_grows_with_train_statics():
    params_only = SR.static_floor_bytes("llama3.1-8b", FULL_TRAIN,
                                        kind="decode")
    no_opt = SR.static_floor_bytes("llama3.1-8b", FULL_TRAIN,
                                   kind="train", include_opt=False)
    full = SR.static_floor_bytes("llama3.1-8b", FULL_TRAIN, kind="train")
    assert params_only < no_opt < full
    ada = SR.static_floor_bytes("llama3.1-8b", FULL_TRAIN, kind="train",
                                optimizer="adafactor")
    assert ada < full
    for arch in ("llama3.1-8b", "arctic-480b", "zamba2-2.7b",
                 "seamless-m4t-large-v2"):
        for kw in (dict(kind="decode"), dict(kind="train"),
                   dict(kind="train", include_opt=False),
                   dict(kind="train", optimizer="adafactor")):
            assert SR.static_floor_bytes(arch, FULL_TRAIN, **kw) \
                == RSR.static_floor_bytes(arch, RS.FULL_TRAIN, **kw)


# ---------------------------------------------------------------------------
# min-chips / frontier: pruned == exhaustive == reference
# ---------------------------------------------------------------------------


MIN_CHIPS_QUERIES = [
    ("llama3.2-3b", (2048, 16, "train"), (4, 8, 16), {}),
    ("llama3.1-8b", (4096, 16, "train"), (8, 16, 32), {}),
    ("deepseek-v2-lite-16b", (2048, 16, "train"), (8, 16, 32),
     {"allow_ep": True, "max_ep": 4}),
    ("qwen3-32b", (4096, 32, "train"), (8, 16, 32),
     {"allow_cp": True, "max_cp": 4}),
    ("llama3.2-3b", (2048, 64, "decode"), (4, 8), {"allow_pp": False}),
    # statics floor above every budget: both sides must agree on None
    ("llama3.1-8b", (2048, 8, "train"), (4,), {}),
    # ep x cp together on the MLA + MoE arch
    ("deepseek-v2-lite-16b", (4096, 32, "train"), (8, 16),
     {"allow_ep": True, "max_ep": 8, "allow_cp": True, "max_cp": 4}),
]


@pytest.mark.parametrize("compute_engine,kw", ENGINES)
@pytest.mark.parametrize("arch,shape,chips,q", MIN_CHIPS_QUERIES,
                         ids=[f"{q[0]}-{q[1][2]}-{i}"
                              for i, q in enumerate(MIN_CHIPS_QUERIES)])
def test_min_chips_pruned_equals_exhaustive(eng, ref_eng, arch, shape,
                                            chips, q, compute_engine, kw):
    shape, rshape = shapes(*shape)
    st = SR.SearchStats()
    got = PL.plan_min_chips(arch, shape, chips=chips, engine=eng,
                            stats=st, compute_engine=compute_engine,
                            **kw, **q)
    exh = PL.plan_min_chips(arch, shape, chips=chips, engine=eng,
                            search="exhaustive", compute_engine="numpy",
                            **q)
    SR._assert_same_cell(got, exh, "min_chips")
    rst = RSR.SearchStats()
    ref = RPL.plan_min_chips(arch, rshape, chips=chips, engine=ref_eng,
                             stats=rst, **q)
    assert cell_of(got) == cell_of(ref)
    assert (st.cells_evaluated, st.cells_pruned) \
        == (rst.cells_evaluated, rst.cells_pruned)
    grid = PL._search_grid(arch, shape, chips, "v5e", FULL_TRAIN, "tpu",
                           PL.HEADROOM, q.get("allow_pp", True), 8,
                           q.get("allow_ep", False), q.get("max_ep", 8),
                           q.get("allow_cp", False), q.get("max_cp", 8),
                           (1, 4, 8), ("1f1b", "gpipe"), None)
    if grid is not None:
        assert st.total_cells == grid.size()
        assert st.cells_evaluated < grid.size()


@pytest.mark.parametrize("compute_engine,kw", ENGINES)
def test_min_chips_search_oracle_mode(eng, compute_engine, kw):
    shape = ShapeConfig("q", 2048, 16, "train")
    grid = PL._search_grid("llama3.2-3b", shape, (4, 8, 16), "v5e",
                           FULL_TRAIN, "tpu", PL.HEADROOM, True, 8,
                           False, 8, False, 8, (1, 4, 8),
                           ("1f1b", "gpipe"), None)
    got = SR.min_chips_search(grid, engine=eng, oracle=True,
                              compute_engine=compute_engine, **kw)
    assert got is not None and got.fits


def test_oracle_catches_a_divergent_answer(eng, monkeypatch):
    """The oracle is a real cross-check: a pruned answer that differs
    from the exhaustive reduction raises."""
    shape = ShapeConfig("q", 2048, 16, "train")
    grid = PL._search_grid("llama3.2-3b", shape, (4, 8, 16), "v5e",
                           FULL_TRAIN, "tpu", PL.HEADROOM, True, 8,
                           False, 8, False, 8, (1, 4, 8),
                           ("1f1b", "gpipe"), None)
    real = SW.SweepResults.min_chips

    def off_by_one(self, **kw):
        r = real(self, **kw)
        if r is not None and self.grid is not grid:   # the pruned slices
            r = dataclasses.replace(r, peak_bytes=r.peak_bytes + 1)
        return r
    monkeypatch.setattr(SW.SweepResults, "min_chips", off_by_one)
    with pytest.raises(AssertionError, match="peak_bytes"):
        SR.min_chips_search(grid, engine=eng, oracle=True,
                            compute_engine="numpy")


FRONTIER_QUERIES = [
    ("llama3.2-3b", (2048, 64, "train"), (4, 8, 16), {}),
    ("llava15-7b", (2048, 128, "train"), (8, 16, 32), {}),
    ("deepseek-v2-lite-16b", (2048, 32, "train"), (16, 32),
     {"allow_ep": True, "max_ep": 4}),
]


@pytest.mark.parametrize("compute_engine,kw", ENGINES)
@pytest.mark.parametrize("arch,shape,chips,q", FRONTIER_QUERIES,
                         ids=[q[0] for q in FRONTIER_QUERIES])
def test_frontier_pruned_equals_exhaustive(eng, ref_eng, arch, shape,
                                           chips, q, compute_engine, kw):
    shape, rshape = shapes(*shape)
    st = SR.SearchStats()
    got = PL.plan_frontier(arch, shape, chips=chips, engine=eng,
                           stats=st, compute_engine=compute_engine,
                           **kw, **q)
    exh = PL.plan_frontier(arch, shape, chips=chips, engine=eng,
                           search="exhaustive", compute_engine="numpy", **q)
    ref = RPL.plan_frontier(arch, rshape, chips=chips, engine=ref_eng, **q)
    assert got == exh == ref
    assert st.cells_evaluated + st.cells_pruned == st.total_cells


def test_unknown_search_and_calibration_rejected(eng):
    shape = ShapeConfig("q", 2048, 16, "train")
    with pytest.raises(ValueError, match="search"):
        PL.plan_min_chips("llama3.2-3b", shape, chips=(4,), engine=eng,
                          search="greedy", compute_engine="numpy")
    with pytest.raises(ValueError, match="search"):
        PL.plan_frontier("llama3.2-3b", shape, chips=(4,), engine=eng,
                         search="greedy", compute_engine="numpy")
    # calibration, refused by earlier slices: every query now takes a
    # profile (plan also a residual model) and gives the reference's answer
    prof, rprof = profiles()
    rshape = RShape("q", 2048, 16, "train")
    got = PL.plan_min_chips("llama3.2-3b", shape, chips=(4, 8, 16),
                            engine=eng, profile=prof, device="cpu")
    ref = RPL.plan_min_chips("llama3.2-3b", rshape, chips=(4, 8, 16),
                             profile=rprof)
    assert cell_of(got) == cell_of(ref) and got is not None
    got = PL.plan_frontier("llama3.2-3b", shape, chips=(4, 8, 16),
                           engine=eng, profile=prof, device="cpu")
    assert got == RPL.plan_frontier("llama3.2-3b", rshape,
                                    chips=(4, 8, 16), profile=rprof)
    assert got
    res, rres = residuals(prof, rprof)
    got = PL.plan("llama3.2-3b", shape, {"data": 2, "model": 2},
                  profile=prof, residual=res)
    ref = RPL.plan("llama3.2-3b", rshape, {"data": 2, "model": 2},
                   profile=rprof, residual=rres)
    assert (got.peak_bytes, got.fits, got.grad_accum, got.note) \
        == (ref.peak_bytes, ref.fits, ref.grad_accum, ref.note)
    assert got.prediction.residual_bytes \
        == ref.prediction.residual_bytes != 0
    got = PL.plan_max_concurrency("llama3.2-3b", 2048, profile=prof)
    ref = RPL.plan_max_concurrency("llama3.2-3b", 2048, profile=rprof)
    assert str(got) == str(ref) and got.max_concurrency > 0


def test_search_runs_on_the_card_by_default(eng, monkeypatch):
    """The search's slices run on the torch engine on a CUDA device
    unless the caller asks for the host; with no card that raises."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PL.plan_min_chips("llama3.2-3b", ShapeConfig("q", 2048, 16, "train"),
                          chips=(4, 8), engine=eng)


# ---------------------------------------------------------------------------
# aligned-ladder concurrency search, replicas, first fit
# ---------------------------------------------------------------------------


def test_batch_align():
    assert SR.batch_align({"data": 2, "model": 2, "pipe": 4}) == 4
    assert SR.batch_align({"pipe": 8}) == 1
    assert SR.batch_align({}) == 1
    assert SR.batch_align({"data": 4, "model": 2, "expert": 2}) == 16


CONC_QUERIES = [
    ("llama3.2-3b", 2048, {"data": 1, "model": 4}, "decode", 512),
    ("llama3.2-3b", 2048, {"data": 2, "model": 2}, "decode", 512),
    ("smollm-360m", 1024, {"data": 4, "model": 1}, "decode", 512),
    ("smollm-360m", 512, {"data": 2, "model": 1}, "prefill", 256),
    ("deepseek-v2-lite-16b", 4096, {"data": 2, "model": 2, "expert": 2},
     "decode", 512),
    ("zamba2-2.7b", 65536, {"data": 1, "model": 2}, "decode", 256),
]


@pytest.mark.parametrize("arch,seq,mesh,kind,cap", CONC_QUERIES,
                         ids=[f"{q[0]}-{q[3]}-d{q[2]['data']}"
                              for q in CONC_QUERIES])
def test_max_concurrency_equals_reference(eng, ref_eng, arch, seq, mesh,
                                          kind, cap):
    st, rst = SR.SearchStats(), RSR.SearchStats()
    rep = PL.plan_max_concurrency(arch, seq, mesh_shape=mesh, kind=kind,
                                  cap=cap, engine=eng, stats=st)
    ref = RPL.plan_max_concurrency(arch, seq, mesh_shape=mesh, kind=kind,
                                   cap=cap, engine=ref_eng, stats=rst)
    assert (rep.max_concurrency, rep.peak_bytes, rep.budget_bytes) \
        == (ref.max_concurrency, ref.peak_bytes, ref.budget_bytes)
    assert st.probes == rst.probes < cap // 4
    assert str(rep) == str(ref)


def test_max_concurrency_nothing_fits(eng):
    rep = PL.plan_max_concurrency("llama3.1-8b", 8192,
                                  mesh_shape={"data": 1, "model": 1},
                                  cap=64, engine=eng)
    assert rep.max_concurrency == 0
    assert rep.peak_bytes > rep.budget_bytes
    with pytest.raises(ValueError, match="cannot serve even one"):
        PL.plan_replicas("llama3.1-8b", 10, 8192,
                         mesh_shape={"data": 1, "model": 1}, engine=eng)


def test_peak_not_monotone_off_ladder(eng):
    """On a batch-sharded mesh peak(gb) is not monotone in raw gb, but it
    is along the aligned ladder (multiples of 4)."""
    budget = int(PL.chip_hbm("v5e") * PL.HEADROOM)
    mesh = {"data": 4, "model": 1}

    def peak(gb):
        return eng.report("smollm-360m", ShapeConfig("c", 1024, gb,
                                                     "decode"),
                          mesh, budget_bytes=budget,
                          chip="v5e").peak_bytes

    vals = [peak(gb) for gb in range(1, 33)]
    assert any(vals[i] > vals[j] for i in range(len(vals))
               for j in range(i + 1, len(vals)))
    ladder = vals[3::4]
    assert all(a <= b for a, b in zip(ladder, ladder[1:]))


def test_monotone_max_synthetic_ladders():
    for align in (1, 3, 4, 7):
        for true_max in (0, 1, 5, 63, 64, 100):
            def fits(gb, m=true_max):
                return gb <= m
            st, rst = SR.SearchStats(), RSR.SearchStats()
            got = SR.monotone_max(fits, cap=100, align=align, stats=st)
            assert got == true_max == RSR.monotone_max(
                fits, cap=100, align=align, stats=rst), (align, true_max)
            assert st.probes == rst.probes <= 40


def test_search_stats_merge():
    a = SR.SearchStats(cells_evaluated=3, cells_pruned=7, probes=2)
    b = SR.SearchStats(cells_evaluated=1, cells_pruned=9, probes=0,
                       bound_evals=4, notes=["x"])
    a.merge(b)
    assert (a.cells_evaluated, a.cells_pruned, a.probes,
            a.bound_evals, a.notes) == (4, 16, 2, 4, ["x"])
    assert a.total_cells == 20
    assert a.reduction == 20 / 6
    assert SR.SearchStats().reduction == float("inf")


@pytest.mark.parametrize("arch,qps,seq,mesh", [
    ("minicpm3-4b", 50, 32768, None),
    ("llama3.2-3b", 7.5, 8192, {"data": 2, "model": 2}),
])
def test_plan_replicas_equals_reference(eng, ref_eng, arch, qps, seq, mesh):
    got = PL.plan_replicas(arch, qps, seq, mesh_shape=mesh, chip="h100",
                           engine=eng)
    ref = RPL.plan_replicas(arch, qps, seq, mesh_shape=mesh, chip="h100",
                            engine=ref_eng)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert str(got) == str(ref)
    with pytest.raises(ValueError, match="positive"):
        PL.plan_replicas(arch, 0, seq, engine=eng)


@pytest.mark.parametrize("arch,shape,mesh", [
    ("llama3.1-8b", (4096, 64, "train"), {"data": 4, "model": 2}),
    ("deepseek-v2-lite-16b", (2048, 32, "train"),
     {"data": 2, "model": 2, "expert": 4}),
    ("seamless-m4t-large-v2", (2048, 16, "prefill"), {"data": 2}),
])
def test_plan_first_fit_equals_reference(eng, ref_eng, arch, shape, mesh):
    shape, rshape = shapes(*shape)
    got = PL.plan(arch, shape, dict(mesh), chip="v5e", engine=eng)
    ref = RPL.plan(arch, rshape, dict(mesh), chip="v5e", engine=ref_eng)
    assert (got.fits, got.peak_bytes, got.budget_bytes, got.grad_accum,
            got.remat, got.note) \
        == (ref.fits, ref.peak_bytes, ref.budget_bytes, ref.grad_accum,
            ref.remat, ref.note)


@pytest.mark.parametrize("arch", ["arctic-480b", "llava15-7b",
                                  "zamba2-2.7b"])
def test_adam_state_bytes_equals_reference(arch):
    assert PL.adam_state_bytes(arch) == RPL.adam_state_bytes(arch)


# ---------------------------------------------------------------------------
# liveness assembly soundness
# ---------------------------------------------------------------------------


def test_liveness_peak_le_legacy_and_floor_sound(eng):
    live = SW.SweepGrid(arch="llava15-7b", chips=(8, 16), chip="v5e",
                        global_batches=(8, 16), seq_lens=(2048,),
                        microbatches=(1, 2), kind="train",
                        assembly="liveness")
    legacy = dataclasses.replace(live, assembly="legacy")
    r_live = eng.sweep(live, engine="torch", device="cpu")
    r_leg = eng.sweep(legacy, engine="torch", device="cpu")
    assert len(r_live) == len(r_leg) > 0
    lp, gp = r_live.columns.peak_bytes, r_leg.columns.peak_bytes
    assert (lp <= gp).all() and (lp < gp).any()
    slack = r_live.columns.overlap_slack_bytes
    assert (slack >= 0).all() and (lp + slack <= gp).all()
    floor = SR._floor_for(live)
    assert int((lp < floor // r_live.columns.n_chips).sum()) == 0


@pytest.mark.parametrize("compute_engine,kw", ENGINES)
def test_min_chips_and_frontier_liveness_oracle(eng, compute_engine, kw):
    shape = ShapeConfig("q", 2048, 16, "train")
    grid = PL._search_grid("llama3.2-3b", shape, (4, 8, 16), "v5e",
                           FULL_TRAIN, "tpu", PL.HEADROOM, True, 8,
                           False, 8, False, 8, (1, 4, 8),
                           ("1f1b", "gpipe"), None)
    grid = dataclasses.replace(grid, assembly="liveness")
    got = SR.min_chips_search(grid, engine=eng, oracle=True,
                              compute_engine=compute_engine, **kw)
    assert got is not None and got.fits
    assert SR.frontier_search(grid, engine=eng, oracle=True,
                              compute_engine=compute_engine, **kw)


def test_max_concurrency_liveness_ladder(eng):
    budget = int(PL.chip_hbm("v5e") * PL.HEADROOM)
    mesh = {"data": 2, "model": 2}

    def peak(gb):
        return eng.report("llama3.2-3b", ShapeConfig("c", 2048, gb,
                                                     "decode"),
                          dict(mesh), budget_bytes=budget, chip="v5e",
                          assembly="liveness").peak_bytes

    cap = 256
    brute = 0
    for gb in range(1, cap + 1):
        if peak(gb) <= budget:
            brute = gb
    st = SR.SearchStats()
    got = SR.max_concurrency_search(peak, budget, cap, mesh_shape=mesh,
                                    stats=st)
    assert got == brute
    assert st.probes < cap // 4


# ---------------------------------------------------------------------------
# the card's queries, answered on the host: the reference's values
# ---------------------------------------------------------------------------


def test_card_min_chips_queries():
    """The two ep x cp ``plan_min_chips`` queries chip_smoke.py runs,
    pruned on the torch engine (host device) with the oracle on, equal to
    the exhaustive host search and to the reference's answers."""
    want = {
        "deepseek-v2-lite-16b": (
            dict(chips=(8, 16, 32, 64, 128, 256)),
            (8, {"data": 1, "model": 4, "expert": 1, "context": 1,
                 "pipe": 2}, 8, "1f1b", 58394783744), (210, 5136)),
        "arctic-480b": (
            dict(chips=(64, 128, 256, 512), max_ep=128),
            (64, {"data": 32, "model": 1, "expert": 1, "context": 1,
                  "pipe": 2}, 8, "1f1b", 68127506308), (1080, 6468)),
    }
    for arch, (q, answer, work) in want.items():
        kw = dict(chip="h100", allow_ep=True, allow_cp=True, **q)
        st = SR.SearchStats()
        eng = SW.SweepEngine()
        grid = PL._search_grid(
            arch, PL._resolve_shape("train_4k"), q["chips"], "h100",
            FULL_TRAIN, "tpu", PL.HEADROOM, True, 8, True,
            q.get("max_ep", 8), True, 8, (1, 4, 8), ("1f1b", "gpipe"), None)
        got = SR.min_chips_search(grid, engine=eng, stats=st, oracle=True,
                                  device="cpu")
        exh = PL.plan_min_chips(arch, "train_4k", search="exhaustive",
                                compute_engine="numpy", **kw)
        SR._assert_same_cell(got, exh, arch)
        assert (got.n_chips, got.mesh_shape, got.microbatches,
                got.schedule, got.peak_bytes) == answer
        assert (st.cells_evaluated, st.cells_pruned) == work
        ref = RPL.plan_min_chips(arch, "train_4k", **kw)
        assert cell_of(got) == cell_of(ref)


def test_card_frontier_concurrency_and_fleet_queries():
    got = PL.plan_frontier("seamless-m4t-large-v2", "train_4k",
                           chips=(1, 2, 4, 8, 16), chip="h100",
                           allow_cp=True, device="cpu")
    assert got == [(1, 8), (2, 128), (4, 256), (8, 256), (16, 256)] \
        == RPL.plan_frontier("seamless-m4t-large-v2", "train_4k",
                             chips=(1, 2, 4, 8, 16), chip="h100",
                             allow_cp=True)
    for arch, seq, want in (("zamba2-2.7b", 524288, (1, 58949008004)),
                            ("minicpm3-4b", 32768, (44, 78942319664))):
        rep = PL.plan_max_concurrency(arch, seq, chip="h100")
        assert (rep.max_concurrency, rep.peak_bytes) == want
    fleet = PL.plan_replicas("minicpm3-4b", 50, 32768, chip="h100")
    assert (fleet.concurrent_requests, fleet.per_replica, fleet.replicas,
            fleet.total_chips) == (500, 44, 12, 12)
    assert PL.adam_state_bytes("arctic-480b") == 5722203303936


# ---------------------------------------------------------------------------
# slices of the card's two new sweeps
# ---------------------------------------------------------------------------


CARD_KNOBS = dict(chip=("v5e", "v6e", "h100"),
                  optimizers=(None, "adamw8bit"), remats=("block", "dots"),
                  grad_accums=(1, 2, 4, 8),
                  global_batches=(8, 64, 512, 4096),
                  seq_lens=(512, 4096), backend="tpu")
CARD_SLICES = {
    "moe_epcp": dict(arch=("deepseek-v2-lite-16b", "arctic-480b"),
                     chips=(64,), mesh_axes=("data", "model", "expert",
                                             "context"),
                     max_axis={"expert": 64, "context": 8},
                     assembly="liveness"),
    "new_archs": dict(arch=("minicpm3-4b", "seamless-m4t-large-v2",
                            "zamba2-2.7b"),
                      chips=(64,), mesh_axes=("data", "model", "context"),
                      max_axis={"context": 8}, assembly="legacy"),
}


@pytest.mark.parametrize("name", sorted(CARD_SLICES))
def test_card_sweep_slice_equals_reference(name):
    """One pod size of each new card grid: fit count, the int64 sum of
    peak_bytes and every column equal the reference's numpy engine, on
    the torch engine (host device) with one batched shard_factor call per
    table build."""
    kw = dict(CARD_SLICES[name], **CARD_KNOBS)
    ref = RSW.SweepEngine().sweep(RSW.SweepGrid(**kw))
    engine = SW.SweepEngine()
    got = engine.sweep(SW.SweepGrid(**kw), engine="torch", device="cpu")
    assert len(got) == len(ref) > 0
    assert got.fit_count == ref.fit_count > 0
    assert int(got.columns.peak_bytes.sum()) \
        == int(ref.columns.peak_bytes.sum())
    for c in ("peak_bytes", "fits", "overlap_slack_bytes", "mesh_c",
              "arch_c", "global_batch", "seq_len"):
        a, b = getattr(ref.columns, c), getattr(got.columns, c)
        assert (a is None) == (b is None), c
        if a is not None:
            assert np.array_equal(a, b), c
    assert engine.last_sweep_stats["table_builds"] == len(kw["arch"])
    meshes = got.columns.meshes
    if "expert" in kw["mesh_axes"]:
        assert any(m["expert"] > 1 for m in meshes)
    assert any(m["context"] > 1 for m in meshes)


# ---------------------------------------------------------------------------
# calibrated searches and request mixes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compute_engine,kw", ENGINES,
                         ids=[e for e, _ in ENGINES])
@pytest.mark.parametrize("arch,shape,chips,q", [
    ("llama3.1-8b", (4096, 16, "train"), (8, 16, 32), {}),
    ("deepseek-v2-lite-16b", (2048, 16, "train"), (8, 16, 32),
     {"allow_ep": True, "max_ep": 4}),
], ids=["llama3.1-8b", "deepseek-ep"])
def test_min_chips_under_profile_equals_reference(eng, ref_eng,
                                                  compute_engine, kw, arch,
                                                  shape, chips, q):
    """Under a profile the statics floor is off (a fitted coefficient
    below 1 could scale bytes under it), so nothing is pruned; the answer
    equals the exhaustive search and the reference's.  A profile that
    scales bytes DOWN makes a smaller pod fit than the raw answer."""
    shape, rshape = shapes(*shape)
    for coefs in (GOLDEN["coefficients"],
                  {"static": 0.55, "act_saved": 0.6,
                   "act_transient": 0.7, "overhead": 0.9}):
        prof, rprof = profiles(coefficients=coefs)
        st = SR.SearchStats()
        got = PL.plan_min_chips(arch, shape, chips=chips, engine=eng,
                                profile=prof, stats=st,
                                compute_engine=compute_engine, **kw, **q)
        exh = PL.plan_min_chips(arch, shape, chips=chips, engine=eng,
                                profile=prof, search="exhaustive",
                                compute_engine="numpy", **q)
        ref = RPL.plan_min_chips(arch, rshape, chips=chips, engine=ref_eng,
                                 profile=rprof, **q)
        assert cell_of(got) == cell_of(exh) == cell_of(ref)
        # the floor is off: every count up to the answer's is swept whole
        grid = PL._search_grid(arch, shape, chips, "v5e", FULL_TRAIN,
                               "tpu", PL.HEADROOM, True, 8,
                               q.get("allow_ep", False), q.get("max_ep", 8),
                               False, 8, (1, 4, 8), ("1f1b", "gpipe"), prof)
        assert SR._floor_for(grid) == 0
        last = got.n_chips if got is not None else max(chips)
        assert st.cells_evaluated == sum(
            SR._slice(grid, meshes).size()
            for n, meshes in SR._by_count(grid).items() if n <= last)
    raw = PL.plan_min_chips(arch, shape, chips=chips, engine=eng,
                            compute_engine="numpy", **q)
    if raw is not None and got is not None:
        assert got.n_chips <= raw.n_chips


MIX_QUERIES = [
    ("llama3.2-3b", 8192, {"data": 1, "model": 2},
     dict(block_size=16, utilization=0.9, prefix_hit_rate=0.5,
          prefix_len=1024, mix="0.25:2048x1,8192x3")),
    ("llama3.2-3b", 4096, {"data": 2, "model": 2},
     dict(block_size=0, mix="0.5")),
    ("llava15-7b", 2048, {"data": 1, "model": 4},
     dict(block_size=16, mix="0.25:512x1,2048x3",
          draft_arch="smollm-360m")),
]


@pytest.mark.parametrize("arch,seq,mesh,knobs", MIX_QUERIES,
                         ids=["llama3.2-3b-paged", "llama3.2-3b-d2",
                              "llava15-7b-draft"])
def test_max_concurrency_under_mix_equals_reference(eng, ref_eng, arch,
                                                     seq, mesh, knobs):
    """plan_max_concurrency / plan_replicas under a request mix equal the
    reference's; a mix that holds less context per slot admits at least
    as many sequences as the mix-free knobs."""
    serve, rserve = serve_specs(**knobs)
    st, rst = SR.SearchStats(), RSR.SearchStats()
    got = PL.plan_max_concurrency(arch, seq, mesh_shape=mesh, serve=serve,
                                  cap=4096, engine=eng, stats=st)
    ref = RPL.plan_max_concurrency(arch, seq, mesh_shape=mesh,
                                   serve=rserve, cap=4096, engine=ref_eng,
                                   stats=rst)
    assert (got.max_concurrency, got.peak_bytes, got.budget_bytes) \
        == (ref.max_concurrency, ref.peak_bytes, ref.budget_bytes)
    assert st.probes == rst.probes and got.max_concurrency > 0
    plain, _ = serve_specs(**dict(knobs, mix=""))
    base = PL.plan_max_concurrency(arch, seq, mesh_shape=mesh, serve=plain,
                                   cap=4096, engine=eng)
    assert got.max_concurrency >= base.max_concurrency
    rep = PL.plan_replicas(arch, 40, seq, mesh_shape=mesh, serve=serve,
                           engine=eng)
    rrep = RPL.plan_replicas(arch, 40, seq, mesh_shape=mesh, serve=rserve,
                             engine=ref_eng)
    assert str(rep) == str(rrep)
