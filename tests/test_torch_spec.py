"""Spec layer of the port against the reference: ``parse_model`` rows are
equal field for field for all twelve archs under every TrainPolicy
preset, ``from_reference`` carries a reference tree across unchanged (an
MLA layer's config object included, so the carried tree predicts the same
bytes), and the archs whose spec was ported before their forward run every
forward entry point now (once they raised from each)."""

import dataclasses

import pytest

from repro.configs import get_config as ref_config
from repro.core import parser as RP
from repro.core import spec as RS
from repro.models import build_model as ref_build
from repro_torch.configs import get_config, registered_archs
from repro_torch.core import parser as TP
from repro_torch.core import spec as TS
from repro_torch.models import build_model

SUPPORTED = tuple(registered_archs())
# the archs whose spec was ported before their forward (ROADMAP A7): the
# MLA archs' forward came with A7b, the hybrid's with A7d
UNSUPPORTED = ("deepseek-v2-lite-16b", "minicpm3-4b", "zamba2-2.7b")
MLA_ARCHS = ("deepseek-v2-lite-16b", "minicpm3-4b")
POLICIES = ("FULL_TRAIN", "LLAVA_STAGE1", "LLAVA_STAGE2")


def row_dict(r) -> dict:
    """A ParsedLayer (either package's) as plain nested dicts."""
    return dataclasses.asdict(r)


def test_registry_lists_the_same_archs():
    from repro.configs import registered_archs as ref_archs
    assert list(registered_archs()) == list(ref_archs())
    assert set(UNSUPPORTED) < set(SUPPORTED) == set(registered_archs())


@pytest.mark.parametrize("arch", registered_archs())
def test_config_equals_reference(arch):
    assert dataclasses.asdict(get_config(arch)) \
        == dataclasses.asdict(ref_config(arch))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", SUPPORTED)
def test_parse_rows_equal_reference(arch, policy):
    ref_rows = RP.parse_model(ref_build(ref_config(arch)).spec,
                              getattr(RS, policy))
    got_rows = TP.parse_model(build_model(get_config(arch)).spec,
                              getattr(TS, policy))
    assert len(got_rows) == len(ref_rows)
    for got, ref in zip(got_rows, ref_rows):
        assert row_dict(got) == row_dict(ref), ref.path
    assert TP.total_params(got_rows) == RP.total_params(ref_rows)
    assert TP.total_params(got_rows, trainable_only=True) \
        == RP.total_params(ref_rows, trainable_only=True)


@pytest.mark.parametrize("arch", SUPPORTED)
def test_from_reference_round_trips(arch):
    ref_spec = ref_build(ref_config(arch)).spec
    as_dict = dataclasses.asdict(ref_spec)
    carried = TS.from_reference(as_dict)
    assert isinstance(carried, TS.ModuleSpec)
    assert dataclasses.asdict(carried) == as_dict
    assert dataclasses.asdict(carried) \
        == dataclasses.asdict(build_model(get_config(arch)).spec)
    assert carried.param_bytes == ref_spec.param_bytes
    # the carried tree drives the port's parser like its own
    rows = TP.parse_model(carried, TS.LLAVA_STAGE2)
    ref_rows = RP.parse_model(ref_spec, RS.LLAVA_STAGE2)
    assert [row_dict(r) for r in rows] == [row_dict(r) for r in ref_rows]


@pytest.mark.parametrize("arch", SUPPORTED)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_spec_equals_reference(arch, kind):
    from repro.configs import ShapeConfig as RShape
    from repro_torch.configs import ShapeConfig as TShape
    ref = ref_build(ref_config(arch)).batch_spec(RShape("t", 1024, 8, kind))
    got = build_model(get_config(arch)).batch_spec(TShape("t", 1024, 8, kind))
    assert list(got) == list(ref)
    for name in ref:
        assert tuple(got[name].shape) == tuple(ref[name].shape), name
        assert TS.dtype_bytes(got[name].dtype) == ref[name].dtype.itemsize


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_carried_mla_tree_predicts_like_the_ports_own(arch):
    """``from_reference`` rebuilds the MLAConfig that ``asdict`` flattened
    into the attention layer's meta, which the predictor reads by
    attribute: the carried reference tree predicts the port's own bytes,
    every component and module, for each step kind at the golden cell."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import planner as PL
    from repro_torch.core import predictor as PR
    from repro_torch.models.registry import Model

    cfg = get_config(arch)
    own = build_model(cfg)
    carried = Model(cfg=cfg, spec=TS.from_reference(
        dataclasses.asdict(ref_build(ref_config(arch)).spec)))
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("golden", 1024, 8, kind)
        ctx = PL.make_context(cfg, {"data": 2, "model": 2}, kind=kind,
                              global_batch=shape.global_batch,
                              seq_len=shape.seq_len, backend="tpu")
        got = PR.predict(carried, TS.FULL_TRAIN, ctx, chip="v5e")
        want = PR.predict(own, TS.FULL_TRAIN, ctx, chip="v5e")
        assert dataclasses.asdict(got) == dataclasses.asdict(want), kind
        assert got.peak_bytes > 0


@pytest.mark.parametrize("arch", ("arctic-480b",) + UNSUPPORTED
                         + ("mamba2-1.3b",))
def test_unsupported_families_raise(arch):
    """Once the check that a spec ported before its forward raised from
    every forward entry point.  No family refuses now: arctic-480b (the
    MoE slice), mamba2 (the SSM training slice), the MLA archs (the MLA
    slice) and zamba2-2.7b (the hybrid slice, tests/test_torch_hybrid.py)
    each run every entry point of their reduced configs on the CPU."""
    import torch
    model = build_model(get_config(arch).reduced())
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((2, 8), dtype=torch.int32)
    loss, _ = model.loss(params, {"tokens": toks, "labels": toks})
    logits, cache = model.prefill(params, {"tokens": toks})
    assert cache["len"].tolist() == [8, 8]
    logits, _ = model.decode_step(params, toks[:, :1],
                                  model.init_cache(2, 4, "cpu"))
    assert bool(torch.isfinite(loss)) and tuple(logits.shape) == \
        (2, 1, model.cfg.vocab)
    # the full config's entry points are routed, none refuses: its cache
    # builds (on the meta device: no memory is taken)
    full = build_model(get_config(arch))
    assert full.init_cache(1, 8, "meta")["len"].shape == (1,)
