"""The ported slice as a whole: the port's capacity sweep
(``engine="torch"`` on ``device="cpu"``, and its host ``engine="numpy"``)
against the reference package's numpy engine on the same grids.  Every
column is an integer (or a bool): tolerance 0."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import batch as RB
from repro.core import batch_jax as RBJ
from repro.core import planner as RPL
from repro.core import sweep as RS
from repro.launch.mesh import arch_rules as ref_arch_rules
from repro_torch.core import batch_torch as BT
from repro_torch.core import spec as TS
from repro_torch.core import sweep as SW
from repro_torch.kernels import segmented_cummax as SC
from repro_torch.kernels import shard_factor as SF

COLUMNS = ("peak_bytes", "budget_bytes", "fits", "offload_bytes",
           "overlap_slack_bytes", "pool_bytes", "draft_bytes",
           "hit_saved_bytes", "arch_c", "chip_c", "mesh_c", "opt_c",
           "remat_c", "sched_c", "srv_c", "off_c", "microbatches",
           "grad_accum", "global_batch", "seq_len")

LLAVA = dict(arch="llava15-7b", chips=(8, 16), chip=("v5e", "h100"),
             optimizers=(None, "adafactor", "adamw8bit"),
             remats=("none", "block", "dots"), grad_accums=(1, 2),
             global_batches=(16, 64), seq_lens=(1024, 2048))
PIPE = dict(arch="llava15-7b", chips=16,
            mesh_axes=("data", "model", "pipe"), max_axis={"pipe": 4},
            schedules=("1f1b", "gpipe"), microbatches=(1, 4),
            grad_accums=(1, 2), global_batches=(16, 64), seq_lens=(1024,))

GRIDS = {
    "kernel-seam-grid": dict(
        arch="smollm-360m", chips=(2, 4), chip="v5e",
        global_batches=(8, 16), seq_lens=(512,), microbatches=(1, 2),
        kind="train"),
    "llava-train": dict(LLAVA, kind="train"),
    "llava-prefill": dict(LLAVA, kind="prefill"),
    "llava-decode": dict(LLAVA, kind="decode"),
    "llava-train-cpu-backend": dict(LLAVA, kind="train", backend="cpu"),
    "pipe": PIPE,
    "offload": dict(arch=("llava15-7b", "llama3.2-3b"), chips=8,
                    optimizers=(None, "adafactor"),
                    offload_optimizer=(False, True),
                    global_batches=(8, 32), seq_lens=(1024,)),
    "pipe-offload": dict(PIPE, offload_optimizer=(False, True)),
    "stage1": dict(LLAVA, policy="LLAVA_STAGE1"),
    "stage2": dict(LLAVA, policy="LLAVA_STAGE2"),
    "dense-zoo": dict(arch=("llama3.1-8b", "llama3.2-3b", "smollm-360m",
                            "qwen3-32b", "llava-next-mistral-7b"),
                      chips=8, remats=(None, "none"), grad_accums=(1, 2),
                      global_batches=(8, 32), seq_lens=(512, 1024)),
    # the pure-SSM family: fp32 state + conv tail in place of a KV cache
    "mamba2-train": dict(arch="mamba2-1.3b", chips=(4, 8),
                         chip=("v5e", "h100"),
                         optimizers=(None, "adafactor"),
                         remats=("none", "block"), grad_accums=(1, 2),
                         global_batches=(8, 32), seq_lens=(1024, 4096),
                         kind="train"),
    "mamba2-decode": dict(arch="mamba2-1.3b", chips=(4, 8), kind="decode",
                          global_batches=(4, 16), seq_lens=(2048, 8192),
                          block_sizes=(0, 16), prefix_hit_rates=(0.0, 0.5),
                          prefix_len=256),
    "paged-decode": dict(arch=("llava15-7b", "llama3.2-3b"), chips=8,
                         kind="decode", global_batches=(4, 8),
                         seq_lens=(1024, 2048), block_sizes=(0, 16),
                         utilizations=(1.0, 0.9),
                         prefix_hit_rates=(0.0, 0.5), prefix_len=256),
    # the MoE archs (deepseek's MLA attention too) over expert x context
    # meshes, and the other three new families over context meshes
    "moe-epcp": dict(arch=("deepseek-v2-lite-16b", "arctic-480b"),
                     chips=(16, 32), mesh_axes=("data", "model", "expert",
                                                "context"),
                     max_axis={"expert": 8, "context": 4},
                     chip=("v5e", "h100"), optimizers=(None, "adamw8bit"),
                     grad_accums=(1, 2), global_batches=(16, 64),
                     seq_lens=(1024,)),
    "new-archs": dict(arch=("minicpm3-4b", "seamless-m4t-large-v2",
                            "zamba2-2.7b"),
                      chips=(8, 16), mesh_axes=("data", "model", "context"),
                      max_axis={"context": 4}, chip=("v5e", "h100"),
                      remats=("block", "dots"), grad_accums=(1, 2),
                      global_batches=(8, 32), seq_lens=(1024, 2048)),
}


def grids(name, assembly, module):
    kw = dict(GRIDS[name], assembly=assembly)
    if "policy" in kw:
        kw["policy"] = getattr(TS if module is SW else RS, kw["policy"])
    return module.SweepGrid(**kw)


def assert_same_columns(got, ref, what):
    assert len(got) == len(ref) and len(ref) > 0
    for c in COLUMNS:
        a, b = getattr(ref.columns, c), getattr(got.columns, c)
        if a is None:
            assert b is None, (what, c)
            continue
        assert b.dtype == a.dtype, (what, c)
        assert np.array_equal(a, b), (what, c)
    for c in ("arch_names", "chip_names", "opt_names", "remat_names",
              "sched_names", "meshes", "offs"):
        assert tuple(getattr(got.columns, c)) \
            == tuple(getattr(ref.columns, c)), (what, c)


@pytest.mark.parametrize("assembly", ["legacy", "liveness"])
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_sweep_equals_reference_numpy_engine(name, assembly):
    ref = RS.SweepEngine().sweep(grids(name, assembly, RS))
    grid = grids(name, assembly, SW)
    got = SW.SweepEngine().sweep(grid, engine="torch", device="cpu")
    assert_same_columns(got, ref, "torch")
    host = SW.SweepEngine().sweep(grid, engine="numpy")
    assert_same_columns(host, ref, "numpy")
    assert got.fit_count == ref.fit_count
    assert got.frontier() == ref.frontier()


@pytest.mark.parametrize("assembly", ["legacy", "liveness"])
def test_rows_and_queries_equal_reference(assembly):
    ref = RS.SweepEngine().sweep(grids("pipe", assembly, RS))
    got = SW.SweepEngine().sweep(grids("pipe", assembly, SW),
                                 engine="torch", device="cpu")
    assert got.to_csv() == ref.to_csv()
    assert str(got.max_global_batch()) == str(ref.max_global_batch())
    assert str(got.min_chips()) == str(ref.min_chips())
    # lazily materialized rows equal the per-cell reference path
    cell = SW.SweepEngine().sweep(grids("pipe", assembly, SW), mode="cell",
                                  engine="numpy")
    for a, b in zip(list(got)[::17], list(cell)[::17]):
        assert a == b


@pytest.mark.parametrize("assembly", ["legacy", "liveness"])
@pytest.mark.parametrize("name", ["llava-train", "pipe-offload",
                                  "paged-decode"])
def test_compose_on_reference_tables(name, assembly, monkeypatch):
    """The device compose run on the REFERENCE's folded tables (carried
    over by ``tables_to_device``) gives the reference's columns — pins a
    difference to the table build or to the composition."""
    ref_grid = grids(name, assembly, RS)
    ref_engine = RS.SweepEngine()
    ref = ref_engine.sweep(ref_grid)
    rcols = RB.build_columns(ref_grid)
    calls = []

    def reference_tables(engine, grid, cols, cfg, model, rows, rules,
                         rep_ctx, arch, env, opt_res, remat_eval, mesh_ids,
                         pp, jobs, drafts, device, stats):
        rcfg, rmodel, rrows = ref_engine._arch_state(arch, ref_grid.policy)
        rrep = RPL.make_context(
            rcfg, dict(rcols.meshes[0]), kind=rcols.kind,
            global_batch=rep_ctx.global_batch, seq_len=rep_ctx.seq_len,
            backend=rcols.backend)
        stacked = RBJ._group_tables(
            ref_engine, ref_grid, rcols, rcfg, rmodel, rrows,
            ref_arch_rules(rcfg, rcols.kind), rrep, arch,
            RB._knob_env(rcfg, rcols, pp), None, opt_res, remat_eval,
            mesh_ids, pp, 1, {})
        assert all(isinstance(v, np.ndarray) for v in stacked.values())
        calls.append(arch)
        return BT.tables_to_device(stacked, device)

    monkeypatch.setattr(BT, "_group_tables", reference_tables)
    got = SW.SweepEngine().sweep(grids(name, assembly, SW), engine="torch",
                                 device="cpu")
    assert calls
    assert_same_columns(got, ref, "reference tables")


def test_tables_to_device_types():
    out = BT.tables_to_device(
        {"a": np.arange(6, dtype=np.int32).reshape(2, 3)[:, ::2],
         "emb": np.asarray([3, 4])}, "cpu")
    assert out["a"].dtype == torch.int64 and out["a"].is_contiguous()
    assert out["a"].tolist() == [[0, 2], [3, 5]]
    assert out["emb"].tolist() == [3, 4]


def test_warm_sweep_reuses_device_tables(monkeypatch):
    engine = SW.SweepEngine()
    grid = grids("pipe", "liveness", SW)
    cold = engine.sweep(grid, engine="torch", device="cpu")
    stats = dict(engine.last_sweep_stats)
    assert stats["groups"] == 3 and stats["table_cache_hits"] == 0
    assert stats["table_build_s"] > 0
    cached = {k: {n: t.data_ptr() for n, t in v.items()}
              for k, v in engine._torch_table_cache.items()}

    def no_build(*a, **k):
        raise AssertionError("warm sweep rebuilt its tables")
    monkeypatch.setattr(BT.B, "_stage_tables_jobs", no_build)
    warm = engine.sweep(grid, engine="torch", device="cpu")
    stats = engine.last_sweep_stats
    assert stats["table_cache_hits"] == stats["groups"] == 3
    assert stats["table_build_s"] == 0.0
    assert {k: {n: t.data_ptr() for n, t in v.items()}
            for k, v in engine._torch_table_cache.items()} == cached
    assert_same_columns(warm, cold, "warm")
    # another assembly is another cache entry, not a stale hit
    monkeypatch.undo()
    engine.sweep(grids("pipe", "legacy", SW), engine="torch", device="cpu")
    assert engine.last_sweep_stats["table_cache_hits"] == 0


def test_cpu_device_launches_no_kernel_and_installs_no_seam():
    before = (SF.launches, SC.launches)
    SW.SweepEngine().sweep(grids("pipe", "liveness", SW), engine="torch",
                           device="cpu")
    assert (SF.launches, SC.launches) == before
    assert BT.B._shard_factor_impl is None
    assert BT.B._liveness_peak_impl is None


@pytest.mark.parametrize("jobs", [1, 3])
@pytest.mark.parametrize("name", ["pipe", "pipe-offload", "paged-decode",
                                  "dense-zoo"])
def test_one_batched_shard_factor_call_per_table_build(name, jobs,
                                                       monkeypatch):
    """Every shard denominator of a stage's table build comes from ONE
    batched ``shard_factor`` call (the plain version on the CPU; the
    kernel, one launch, on a card), also with the build split over worker
    threads; the grid still equals the reference's numpy engine."""
    calls = []
    real = SF.shard_factor_batch
    monkeypatch.setattr(SF, "shard_factor_batch",
                        lambda b: calls.append(len(b.host.requests))
                        or real(b))
    engine = SW.SweepEngine()
    got = engine.sweep(grids(name, "liveness", SW), engine="torch",
                       device="cpu", jobs=jobs)
    stats = engine.last_sweep_stats
    assert len(calls) == stats["table_builds"] >= stats["groups"] > 0
    assert stats["shard_factor_batches"] == len(calls)
    assert sum(calls) == stats["shard_factor_requests"]
    ref = RS.SweepEngine().sweep(grids(name, "liveness", RS))
    assert_same_columns(got, ref, "torch")


def test_jobs_split_is_order_identical():
    grid = grids("llava-train", "liveness", SW)
    one = SW.SweepEngine().sweep(grid, engine="torch", device="cpu")
    many = SW.SweepEngine().sweep(grid, engine="torch", device="cpu", jobs=3)
    assert_same_columns(many, one, "jobs")


GOLDEN_COEFS = {"static": 1.0417, "act_saved": 0.9313,
                "act_transient": 1.1902, "overhead": 0.8641}
GOLDEN_CHIPS = {"v5e": 134217728, "*": 33554432}
# a second profile, scaling bytes down, with its own per-chip offsets
SECOND_COEFS = {"static": 0.97, "act_saved": 1.2125,
                "act_transient": 0.8333, "overhead": 1.05}
SECOND_CHIPS = {"h100": 1073741824, "v6e": 268435456}


def profile_of(module, coefs=GOLDEN_COEFS, chips=GOLDEN_CHIPS):
    """The same CalibrationProfile in the port (``module is SW``) or the
    reference package."""
    if module is SW:
        from repro_torch.calibrate.profile import CalibrationProfile
    else:
        from repro.calibrate.profile import CalibrationProfile
    return CalibrationProfile(coefficients=dict(coefs),
                              chip_constant_bytes=dict(chips))


def residual_of(module, profile):
    """A fixed learned residual model over ``profile``, in either
    package (17 weights per family, GiB scale)."""
    if module is SW:
        from repro_torch.calibrate import learned
    else:
        from repro.calibrate import learned
    w = tuple(round(0.013 * ((i * 7) % 5 - 2), 4) for i in range(17))
    return learned.ResidualModel.from_dict({
        "schema_version": 1, "kind": "residual_model",
        "features": list(learned.FEATURE_NAMES),
        "families": {"vlm": list(w)},
        "global": [x / 2 for x in w],
        "base_profile_hash": profile.profile_hash,
        "created": "", "source": {}, "fit": {}})


def mix_of(module, text):
    if module is SW:
        from repro_torch.serve.fleet import parse_mix
    else:
        from repro.serve.fleet import parse_mix
    return parse_mix(text)


# the knobs earlier slices deferred (each was refused with a
# NotImplementedError): every one now sweeps on both engines to the
# reference's numpy engine; the torch engine refuses only the residual
# grid, whose correction is applied per cell, and names the engine that
# takes it
DEFERRED = {
    "profile": lambda m: dict(profile=profile_of(m)),
    "residual_model": lambda m: dict(profile=profile_of(m),
                                     residual_model=residual_of(
                                         m, profile_of(m))),
    "mixes": lambda m: dict(kind="decode", mixes=(
        None, mix_of(m, "0.25:512x1,2048x3"), mix_of(m, "0.5"))),
    "draft_archs": lambda m: dict(kind="decode",
                                  draft_archs=("", "smollm-360m")),
}


@pytest.mark.parametrize("engine", ["torch", "numpy"])
@pytest.mark.parametrize("knob", sorted(DEFERRED))
def test_deferred_knobs_are_rejected(knob, engine):
    base = dict(arch="llava15-7b", chips=4, chip=("v5e", "h100"),
                global_batches=(8,), seq_lens=(512, 2048))
    grid = SW.SweepGrid(**{**base, **DEFERRED[knob](SW)})
    ref = RS.SweepEngine().sweep(RS.SweepGrid(**{**base,
                                                 **DEFERRED[knob](RS)}))
    if knob == "residual_model" and engine == "torch":
        with pytest.raises(ValueError, match="engine='numpy'"):
            SW.SweepEngine().sweep(grid, engine="torch", device="cpu")
        engine = "numpy"
    got = SW.SweepEngine().sweep(
        grid, engine=engine,
        **({"device": "cpu"} if engine == "torch" else {}))
    assert len(got) == len(ref) > 0
    assert got.to_csv() == ref.to_csv()
    assert [r.peak_bytes for r in got] == [r.peak_bytes for r in ref]
    if knob == "residual_model":
        assert got.columns is None     # the cell path
        assert any(r.prediction is None for r in got)
    else:
        assert_same_columns(got, ref, engine)


PROFILED = {
    "llava-train": dict(LLAVA, kind="train"),
    "pipe-gpipe-offload": dict(PIPE, chip=("v5e", "h100", "v6e"),
                               offload_optimizer=(False, True)),
    "llava-prefill": dict(LLAVA, kind="prefill"),
    "paged-decode": GRIDS["paged-decode"],
    "mix-draft-decode": dict(GRIDS["paged-decode"], chip=("v5e", "h100"),
                             mixes="mixes", draft_archs=("", "smollm-360m",
                                                         "llama3.2-3b")),
    "moe-epcp": GRIDS["moe-epcp"],
}


def profiled_grid(name, assembly, module, profile):
    kw = dict(PROFILED[name], assembly=assembly, profile=profile)
    if kw.get("mixes") == "mixes":
        kw["mixes"] = (None, mix_of(module, "0.25:512x1,2048x3"),
                       mix_of(module, "0.5"))
    return module.SweepGrid(**kw)


@pytest.mark.parametrize("assembly", ["legacy", "liveness"])
@pytest.mark.parametrize("name", sorted(PROFILED))
def test_profiled_sweep_equals_reference_numpy_engine(name, assembly):
    """Under a calibration profile both port engines equal the reference's
    numpy engine as integers: the torch engine's host folds (rint in
    float64, the act_transient group folded whole, telescoped under
    liveness) and its per-chip offset after the stage max."""
    ref = RS.SweepEngine().sweep(
        profiled_grid(name, assembly, RS, profile_of(RS)))
    grid = profiled_grid(name, assembly, SW, profile_of(SW))
    got = SW.SweepEngine().sweep(grid, engine="torch", device="cpu")
    assert_same_columns(got, ref, "torch")
    host = SW.SweepEngine().sweep(grid, engine="numpy")
    assert_same_columns(host, ref, "numpy")
    # the profile moved the answer: the offsets alone shift every peak
    raw = SW.SweepEngine().sweep(profiled_grid(name, assembly, SW, None),
                                 engine="numpy")
    assert not np.array_equal(raw.columns.peak_bytes,
                              got.columns.peak_bytes)


def test_two_profiles_in_a_row_on_one_engine():
    """One engine, the same grid under two profiles and none: every sweep
    equals the reference's, because the profile hash keys the device
    tables; a warm repeat hits the cache."""
    engine = SW.SweepEngine()
    profiles = ((profile_of(SW), profile_of(RS)),
                (profile_of(SW, SECOND_COEFS, SECOND_CHIPS),
                 profile_of(RS, SECOND_COEFS, SECOND_CHIPS)),
                (None, None))
    for assembly in ("legacy", "liveness"):
        for prof, rprof in profiles + profiles[:1]:
            got = engine.sweep(
                profiled_grid("pipe-gpipe-offload", assembly, SW, prof),
                engine="torch", device="cpu")
            ref = RS.SweepEngine().sweep(
                profiled_grid("pipe-gpipe-offload", assembly, RS, rprof))
            assert_same_columns(got, ref, (assembly, prof))
        assert engine.last_sweep_stats["table_cache_hits"] \
            == engine.last_sweep_stats["groups"] == 3
    assert len(engine._torch_table_cache) == 2 * 3 * 3


@pytest.mark.parametrize("assembly", ["legacy", "liveness"])
@pytest.mark.parametrize("name", ["llava-train", "paged-decode"])
def test_compose_on_reference_profiled_tables(name, assembly, monkeypatch):
    """The device compose on the REFERENCE's profile-folded tables (its
    ``ctr`` table included) gives the reference's columns."""
    ref_grid = profiled_grid(name, assembly, RS, profile_of(RS))
    ref_engine = RS.SweepEngine()
    ref = ref_engine.sweep(ref_grid)
    rcols = RB.build_columns(ref_grid)

    def reference_tables(engine, grid, cols, cfg, model, rows, rules,
                         rep_ctx, arch, env, opt_res, remat_eval, mesh_ids,
                         pp, jobs, drafts, device, stats):
        rcfg, rmodel, rrows = ref_engine._arch_state(arch, ref_grid.policy)
        rrep = RPL.make_context(
            rcfg, dict(rcols.meshes[0]), kind=rcols.kind,
            global_batch=rep_ctx.global_batch, seq_len=rep_ctx.seq_len,
            backend=rcols.backend)
        stacked = RBJ._group_tables(
            ref_engine, ref_grid, rcols, rcfg, rmodel, rrows,
            ref_arch_rules(rcfg, rcols.kind), rrep, arch,
            RB._knob_env(rcfg, rcols, pp), ref_grid.profile, opt_res,
            remat_eval, mesh_ids, pp, 1, RB._draft_states(ref_engine,
                                                          rcols))
        assert "ctr" in stacked
        return BT.tables_to_device(stacked, device)

    monkeypatch.setattr(BT, "_group_tables", reference_tables)
    got = SW.SweepEngine().sweep(
        profiled_grid(name, assembly, SW, profile_of(SW)), engine="torch",
        device="cpu")
    assert_same_columns(got, ref, "reference tables")


def test_torch_engine_refuses_residual_grids():
    """A residual grid on the torch engine is refused with a ValueError
    naming the engine that takes it; nothing drops the residual."""
    prof = profile_of(SW)
    grid = SW.SweepGrid(arch="smollm-360m", chips=4, global_batches=(16,),
                        seq_lens=(256,), profile=prof,
                        residual_model=residual_of(SW, prof))
    for call in (lambda: SW.SweepEngine().sweep(grid, engine="torch",
                                                device="cpu"),
                 lambda: BT.sweep_columnar_torch(SW.SweepEngine(), grid,
                                                 device="cpu")):
        with pytest.raises(ValueError, match="engine='numpy'"):
            call()
    with pytest.raises(ValueError, match="RequestMix"):
        SW.SweepGrid(arch="smollm-360m", chips=4, kind="decode",
                     mixes=(object(),)).serve_specs()


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_keep_predictions(engine):
    """The numpy engine takes the cell path and keeps each cell's
    PredictedMemory, equal to the reference's; the torch engine does not
    materialize breakdowns and refuses the grid."""
    kw = dict(arch="deepseek-v2-lite-16b",
              mesh_shapes=[{"data": 2, "expert": 2},
                           {"data": 1, "context": 2, "pipe": 2}],
              schedules=("1f1b", "gpipe"), microbatches=(1, 4),
              global_batches=(8,), seq_lens=(1024,), keep_predictions=True)
    grid = SW.SweepGrid(**kw)
    if engine == "torch":
        with pytest.raises(ValueError, match="keep_predictions"):
            SW.SweepEngine().sweep(grid, engine="torch", device="cpu")
        return
    got = SW.SweepEngine().sweep(grid, engine="numpy")
    ref = RS.SweepEngine().sweep(RS.SweepGrid(**kw))
    assert got.columns is None and len(got) == len(ref) > 0
    for a, b in zip(got.results, ref.results):
        assert a.prediction is not None
        assert dataclasses.asdict(a.prediction) \
            == dataclasses.asdict(b.prediction)
        assert (a.peak_bytes, a.fits) == (b.peak_bytes, b.fits)


def test_engine_and_mode_validation():
    grid = SW.SweepGrid(arch="smollm-360m", chips=2, global_batches=(8,),
                        seq_lens=(512,))
    with pytest.raises(ValueError, match="engine"):
        SW.SweepEngine().sweep(grid, engine="jax")
    with pytest.raises(ValueError, match="mode"):
        SW.SweepEngine().sweep(grid, mode="rows", engine="numpy")
    with pytest.raises(ValueError, match="cell"):
        SW.SweepEngine().sweep(grid, mode="cell", engine="torch",
                               device="cpu")
    with pytest.raises(ValueError, match="device"):
        SW.SweepEngine().sweep(grid, engine="numpy", device="cpu")
    # module-level shorthand drives the same engines
    a = SW.sweep(grid, engine="torch", device="cpu")
    b = SW.sweep(grid, engine="numpy")
    assert_same_columns(a, b, "shorthand")
