"""Expert-parallel (ep) and context-parallel (cp) mesh axes in the port,
against the reference package (the uncalibrated cases of
tests/test_epcp.py).

* **Inertness** — ``expert=1`` / ``context=1`` / ``pipe=1`` is
  byte-identical to the axis-free mesh on every arch and step kind.
* **Semantics** — ``expert`` divides exactly the MoE weight stacks and
  dispatch buffers; ``context`` divides the seq dim of train/prefill
  activations and adds the ring-attention per-hop KV transient.
* **Parity** — the port's ``planner.check``, its per-cell path, its numpy
  engine and its torch engine (``device="cpu"``) equal the reference's
  numpy engine and ``planner.check`` on ep x cp x pp grids.  Integers:
  tolerance 0.
"""

import dataclasses

import pytest

from repro.configs import ShapeConfig as RShape
from repro.core import planner as RPL
from repro.core import sweep as RSW
from repro.mesh_ctx import DEFAULT_RULES as REF_RULES
from repro.mesh_ctx import shard_factor as ref_shard_factor
from repro_torch.configs import ShapeConfig, get_config, registered_archs
from repro_torch.core import factors as F
from repro_torch.core import planner as PL
from repro_torch.core import sweep as SW
from repro_torch.core.parser import parse_model
from repro_torch.core.spec import FULL_TRAIN
from repro_torch.mesh_ctx import DEFAULT_RULES, shard_factor
from repro_torch.models import build_model

ARCHS = registered_archs()
MOE_ARCHS = [a for a in ARCHS if get_config(a).moe is not None]
ENGINES = [("torch", {"device": "cpu"}), ("numpy", {})]

#: ep x cp x pp crossed
EPCP_PP_MESHES = [
    {"data": 2, "model": 1, "expert": e, "context": c, "pipe": p}
    for e in (1, 2, 4) for c in (1, 2, 4) for p in (1, 2, 4)]

COMPONENTS = ("param_bytes", "grad_bytes", "opt_bytes", "act_saved_bytes",
              "act_transient_bytes", "loss_bytes", "input_bytes",
              "cache_bytes", "output_copy_bytes", "peak_bytes")


@pytest.fixture(scope="module")
def engine():
    return SW.SweepEngine()


def assert_same_prediction(got, ref, what):
    for c in COMPONENTS:
        assert getattr(got, c) == getattr(ref, c), (what, c)
    assert got.per_module == ref.per_module, what


# ---------------------------------------------------------------------------
# inertness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_trivial_ep_cp_axes_byte_identical_per_arch(arch, engine):
    """expert=1 x context=1 x pipe=1 == the axis-free mesh for every
    component of every kind, and both equal the reference's."""
    budget = int(PL.chip_hbm("v5e") * PL.HEADROOM)
    trivial = {"data": 2, "model": 2, "expert": 1, "context": 1, "pipe": 1}
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("cell", 1024, 8, kind)
        base = engine.report(arch, shape, {"data": 2, "model": 2},
                             backend="tpu", budget_bytes=budget)
        triv = engine.report(arch, shape, dict(trivial), backend="tpu",
                             budget_bytes=budget)
        ref = RPL.check(arch, RShape("cell", 1024, 8, kind), dict(trivial),
                        backend="tpu")
        assert_same_prediction(triv.prediction, base.prediction,
                               (arch, kind))
        assert_same_prediction(triv.prediction, ref.prediction,
                               (arch, kind, "reference"))


# ---------------------------------------------------------------------------
# semantics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ep_divides_only_moe_terms(arch):
    """The expert axis shrinks MoE params and dispatch buffers; every
    dense module's bytes are untouched; both as in the reference."""
    shape = ShapeConfig("cell", 1024, 8, "train")
    base = PL.check(arch, shape, {"data": 2, "model": 1})
    ep = PL.check(arch, shape, {"data": 2, "model": 1, "expert": 4})
    assert ep.prediction.param_bytes < base.prediction.param_bytes
    shrunk = []
    for path, m in base.prediction.per_module.items():
        e = ep.prediction.per_module[path]
        rows = (m["param"], m["grad"], m["opt"], m["act"])
        erows = (e["param"], e["grad"], e["opt"], e["act"])
        if "blocks" in path:            # the MoE stacks live here
            shrunk.append(erows < rows)
        else:                           # embed / head / norms: untouched
            assert erows == rows, path
    assert any(shrunk)
    ref = RPL.check(arch, RShape("cell", 1024, 8, "train"),
                    {"data": 2, "model": 1, "expert": 4})
    assert_same_prediction(ep.prediction, ref.prediction, arch)


def test_ep_shard_factor_on_expert_dims_only():
    """`expert` divides `experts` / `expert_buf` dims and nothing else."""
    mesh = {"data": 2, "model": 2, "expert": 4}
    rules = dict(DEFAULT_RULES)
    cases = [((64, 2048, 1408), ("experts", "embed", None), 8),
             ((64,), ("experts",), 8), ((15360,), ("expert_buf",), 4)]
    for dims, axes, want in cases:
        assert shard_factor(dims, axes, mesh, rules) == want
        assert ref_shard_factor(dims, axes, mesh, dict(REF_RULES)) == want
    for ax in ("heads", "ffn", "vocab", "batch"):
        with_ep = shard_factor((64, 4096), (ax, None), mesh, rules)
        without = shard_factor((64, 4096), (ax, None),
                               {"data": 2, "model": 2}, rules)
        assert with_ep == without, ax


def test_cp_divides_seq_activations_and_adds_ring_transient():
    shape = ShapeConfig("cell", 2048, 8, "train")
    base = PL.check("llama3.2-3b", shape, {"data": 2, "model": 1})
    cp = PL.check("llama3.2-3b", shape,
                  {"data": 2, "model": 1, "context": 4})
    assert cp.prediction.act_saved_bytes * 4 \
        == base.prediction.act_saved_bytes
    ref = RPL.check("llama3.2-3b", RShape("cell", 2048, 8, "train"),
                    {"data": 2, "model": 1, "context": 4})
    assert_same_prediction(cp.prediction, ref.prediction, "cp")
    cfg = get_config("llama3.2-3b")
    rows = parse_model(build_model(cfg).spec, FULL_TRAIN)
    attn = next(r for r in rows if r.layer.kind == "attention")
    spec = F.ring_kv_spec(attn)
    assert spec is not None and spec.nbytes == 2 and spec.mult == 4
    ctx = PL.make_context(cfg, {"data": 2, "model": 1, "context": 4},
                          kind="train", global_batch=8, seq_len=2048)
    assert F._ring_bytes(attn, ctx) > 0
    ctx1 = PL.make_context(cfg, {"data": 2, "model": 1}, kind="train",
                           global_batch=8, seq_len=2048)
    assert F._ring_bytes(attn, ctx1) == 0


def test_cp_shards_prefill_cache_but_not_decode():
    from repro_torch.launch.mesh import arch_rules
    cfg = get_config("llama3.2-3b")
    assert "context" in arch_rules(cfg, "train")["seq"]
    assert "context" in arch_rules(cfg, "prefill")["seq"]
    assert arch_rules(cfg, "prefill")["cache_seq"][0] == "context"
    assert "context" not in arch_rules(cfg, "decode").get("cache_seq", ())
    assert "context" not in arch_rules(cfg, "decode").get("seq", ())
    shape = ShapeConfig("cell", 2048, 8, "prefill")
    base = PL.check("llama3.1-8b", shape, {"data": 1, "model": 1})
    cp4 = PL.check("llama3.1-8b", shape,
                   {"data": 1, "model": 1, "context": 4})
    assert cp4.prediction.cache_bytes * 4 == base.prediction.cache_bytes


@pytest.mark.parametrize("compute_engine,kw", ENGINES)
def test_plan_min_chips_filters_illegal_enumerations(compute_engine, kw):
    """Enumerated meshes check_parallel would reject are filtered, not
    fatal; each answer is the reference's."""
    queries = [
        ("deepseek-v2-lite-16b", (1002, 8, "train"), (32, 64),
         dict(allow_cp=True, max_cp=4)),
        ("smollm-360m", (1024, 8, "train"), (8,), dict(allow_ep=True)),
        ("smollm-360m", (512, 4, "decode"), (8,),
         dict(allow_cp=True, allow_pp=False)),
    ]
    for arch, (seq, gb, kind), chips, q in queries:
        got = PL.plan_min_chips(arch, ShapeConfig("cell", seq, gb, kind),
                                chips=chips, compute_engine=compute_engine,
                                **kw, **q)
        ref = RPL.plan_min_chips(arch, RShape("cell", seq, gb, kind),
                                 chips=chips, **q)
        assert (got is None) == (ref is None), arch
        if ref is not None:
            assert (got.n_chips, got.mesh_shape, got.peak_bytes,
                    got.microbatches, got.schedule, got.ep, got.cp) \
                == (ref.n_chips, ref.mesh_shape, ref.peak_bytes,
                    ref.microbatches, ref.schedule, ref.ep, ref.cp)
    first = PL.plan_min_chips("deepseek-v2-lite-16b",
                              ShapeConfig("cell", 1002, 8, "train"),
                              chips=(32, 64), allow_cp=True, max_cp=4,
                              compute_engine=compute_engine, **kw)
    assert first is not None and first.cp in (1, 2)


def test_ring_spec_shapes_gqa_vs_mla():
    gqa_rows = parse_model(build_model(get_config("llama3.1-8b")).spec,
                           FULL_TRAIN)
    mla_rows = parse_model(
        build_model(get_config("deepseek-v2-lite-16b")).spec, FULL_TRAIN)
    gqa = next(r for r in gqa_rows if r.layer.kind == "attention")
    mla = next(r for r in mla_rows if r.layer.kind == "attention"
               and r.layer.meta.get("attn_kind") == "mla")
    assert F.ring_kv_spec(gqa).mult == 4     # (k + v) x (send + recv)
    sm = F.ring_kv_spec(mla)
    assert sm.mult == 2                      # one latent x (send + recv)
    mcfg = get_config("deepseek-v2-lite-16b").mla
    assert mcfg.kv_lora_rank + mcfg.qk_rope_head_dim in sm.dims
    ssm_rows = parse_model(build_model(get_config("mamba2-1.3b")).spec,
                           FULL_TRAIN)
    assert all(F.ring_kv_spec(r) is None for r in ssm_rows
               if r.layer.kind != "attention")


def test_predict_context_ep_cp_properties():
    ctx = F.PredictContext(mesh_shape={"data": 2, "expert": 4,
                                       "context": 2})
    assert (ctx.ep, ctx.cp) == (4, 2)
    assert F.PredictContext(mesh_shape={}).ep == 1
    assert F.PredictContext(mesh_shape={}).cp == 1
    mctx = PL.make_context(
        get_config("deepseek-v2-lite-16b"),
        {"data": 2, "expert": 4, "context": 2, "pipe": 2},
        kind="train", global_batch=8, seq_len=1024)
    assert (mctx.ep, mctx.cp, mctx.pp) == (4, 2, 2)


# ---------------------------------------------------------------------------
# parity: check == cell == columnar == reference on ep x cp x pp grids
# ---------------------------------------------------------------------------


def epcp_grid(module, kind):
    return module.SweepGrid(
        arch="deepseek-v2-lite-16b", mesh_shapes=EPCP_PP_MESHES,
        kind=kind, schedules=("1f1b", "gpipe"), microbatches=(1, 4),
        grad_accums=(1, 2) if kind == "train" else (1,),
        global_batches=(8,), seq_lens=(1024,), backend="cpu")


def rows_of(res) -> list:
    return [dataclasses.replace(r, prediction=None) for r in res.results]


@pytest.mark.parametrize("compute_engine,kw", ENGINES)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_columnar_matches_reference_epcp_pp_grid(kind, compute_engine, kw):
    ref = RSW.SweepEngine().sweep(epcp_grid(RSW, kind))
    got = SW.SweepEngine().sweep(epcp_grid(SW, kind),
                                 engine=compute_engine, **kw)
    cell = SW.SweepEngine().sweep(epcp_grid(SW, kind), mode="cell",
                                  engine="numpy")
    assert len(got) == len(ref) == len(cell) > 0
    want = [dataclasses.asdict(r) for r in ref.results]
    assert [dataclasses.asdict(r) for r in rows_of(got)] == want
    assert [dataclasses.asdict(r) for r in rows_of(cell)] == want


@pytest.mark.parametrize("compute_engine,kw", ENGINES)
def test_columnar_matches_reference_cp_dense_arch(compute_engine, kw):
    """cp on a dense (non-MoE) arch: legal, and still byte-par."""
    def grid(module):
        return module.SweepGrid(
            arch="llava15-7b",
            mesh_shapes=[{"data": 2, "context": 2},
                         {"data": 1, "context": 4, "pipe": 2},
                         {"model": 2, "context": 2}],
            schedules=("1f1b",), microbatches=(1, 4),
            global_batches=(8, 16), seq_lens=(1024,), backend="cpu")
    ref = RSW.SweepEngine().sweep(grid(RSW))
    got = SW.SweepEngine().sweep(grid(SW), engine=compute_engine, **kw)
    assert [dataclasses.asdict(r) for r in rows_of(got)] \
        == [dataclasses.asdict(r) for r in ref.results]


def test_cell_path_matches_unmemoized_check_epcp():
    grid = SW.SweepGrid(
        arch="deepseek-v2-lite-16b",
        mesh_shapes=[{"data": 1, "model": 1, "expert": 4, "context": 2,
                      "pipe": 2}],
        schedules=("1f1b", "gpipe"), microbatches=(1, 4),
        global_batches=(8,), seq_lens=(1024,), backend="cpu")
    res = SW.SweepEngine().sweep(grid, mode="cell", engine="numpy")
    assert len(res) > 0
    for r in res.results:
        kw = dict(backend=r.backend, grad_accum=r.grad_accum,
                  remat=r.remat, optimizer=r.optimizer, chip=r.chip,
                  microbatches=r.microbatches, schedule=r.schedule)
        got = PL.check(r.arch, ShapeConfig("cell", r.seq_len,
                                           r.global_batch, r.kind),
                       r.mesh_shape, **kw)
        ref = RPL.check(r.arch, RShape("cell", r.seq_len, r.global_batch,
                                       r.kind), r.mesh_shape, **kw)
        assert got.peak_bytes == ref.peak_bytes == r.peak_bytes, r


@pytest.mark.parametrize("compute_engine,kw", ENGINES)
def test_sweep_result_exposes_ep_cp(compute_engine, kw):
    grid = SW.SweepGrid(
        arch="deepseek-v2-lite-16b",
        mesh_shapes=[{"data": 2, "expert": 2, "context": 2}],
        global_batches=(8,), seq_lens=(1024,), backend="tpu")
    r = SW.sweep(grid, engine=compute_engine, **kw).results[0]
    assert (r.ep, r.cp, r.pp) == (2, 2, 1)


def test_enumerate_meshes_expert_context_axes():
    from repro.launch.mesh import enumerate_meshes as ref_enumerate
    from repro_torch.launch.mesh import (cp_degree, enumerate_meshes,
                                         ep_degree)
    args = (16, ("data", "expert", "context"), {"expert": 4, "context": 2})
    meshes = enumerate_meshes(*args)
    assert meshes == ref_enumerate(*args)
    assert all(m["data"] * m["expert"] * m["context"] == 16
               for m in meshes)
    assert {ep_degree(m) for m in meshes} == {1, 2, 4}
    assert {cp_degree(m) for m in meshes} == {1, 2}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_grid_check_parallel_rejects_like_the_reference(kind):
    """The grid-level gate is ``planner.check_parallel``, the reference's:
    an expert axis on a dense arch, context on decode, a context degree
    that does not divide seq_len and expert > n_experts each fail with the
    reference's message."""
    bad = [("llava15-7b", [{"data": 2, "expert": 2}], 1024),
           ("deepseek-v2-lite-16b", [{"data": 2, "context": 2}], 1024),
           ("deepseek-v2-lite-16b", [{"data": 1, "context": 4}], 1002),
           ("deepseek-v2-lite-16b", [{"data": 1, "expert": 128}], 1024)]
    for arch, meshes, seq in bad:
        kw = dict(arch=arch, mesh_shapes=meshes, global_batches=(8,),
                  seq_lens=(seq,), kind=kind)
        try:
            RSW.SweepGrid(**kw).check_parallel()
            ref_msg = None
        except ValueError as e:
            ref_msg = str(e)
        if ref_msg is None:
            SW.SweepGrid(**kw).check_parallel()
            continue
        with pytest.raises(ValueError) as err:
            SW.SweepEngine().sweep(SW.SweepGrid(**kw), engine="torch",
                                   device="cpu")
        assert str(err.value) == ref_msg
