"""Request mixes and speculative drafts of the port
(``repro_torch.serve.fleet``, the mix line of ``serve/pool.py``, the mix
and draft axes of the sweep) against the reference package on the same
inputs.  All of it is exact-integer arithmetic: tolerance 0."""

import numpy as np
import pytest

from repro.core import sweep as RS
from repro.serve import fleet as RF
from repro.serve import pool as RP
from repro_torch.core import sweep as SW
from repro_torch.serve import fleet as TF
from repro_torch.serve import pool as TP

MIX_TEXTS = ("0.25:512x1,2048x3", "0.5", "0:1024x2,4096x1", "1:100x1",
             "0.3:65536x1", "0.125:7x3,8x5,9x7", "", "0")


@pytest.mark.parametrize("text", MIX_TEXTS)
def test_parse_mix_and_expected_len_equal_reference(text):
    got, ref = TF.parse_mix(text), RF.parse_mix(text)
    assert (got is None) == (ref is None)
    if got is not None:
        assert (got.prefill_bp, got.hist) == (ref.prefill_bp, ref.hist)
        assert not got.is_identity
    rng = np.random.default_rng(len(text))
    for seq in [1, 2, 3, 511, 512, 2048, 8192] + list(
            rng.integers(1, 1 << 17, 20)):
        assert TF.expected_len(int(seq), got) \
            == RF.expected_len(int(seq), ref) >= 1


@pytest.mark.parametrize("text", ["abc", "0.2:512", "0.2:axb", "1.5",
                                  "-0.1", "0.2:0x1", "0.2:512x0"])
def test_bad_mixes_raise_as_the_reference(text):
    with pytest.raises(ValueError) as ref:
        RF.parse_mix(text)
    with pytest.raises(ValueError) as got:
        TF.parse_mix(text)
    assert str(got.value) == str(ref.value)


def test_identity_mix_keeps_a_spec_neutral():
    assert TF.RequestMix.make(0.0).is_identity
    spec = TP.ServeSpec.make(mix=TF.RequestMix())
    assert spec.is_neutral
    assert RP.ServeSpec.make(mix=RF.RequestMix()).is_neutral
    assert not TP.ServeSpec.make(mix=TF.parse_mix("0.5")).is_neutral
    assert TP.BP is TF.BP


@pytest.mark.parametrize("block,util,hit", [(0, 1.0, 0.0), (16, 0.9, 0.5),
                                            (32, 0.75, 1.0), (8, 1.0, 0.25)])
def test_pool_ledger_under_mix_equals_reference(block, util, hit):
    for text in MIX_TEXTS[:6]:
        kw = dict(block_size=block, utilization=util, prefix_hit_rate=hit,
                  prefix_len=300)
        got = TP.ServeSpec.make(mix=TF.parse_mix(text), **kw)
        ref = RP.ServeSpec.make(mix=RF.parse_mix(text), **kw)
        for seq in (64, 1000, 2048, 8191):
            a = TP.pool_accounting(seq, got)
            b = RP.pool_accounting(seq, ref)
            assert a.__dict__ == b.__dict__
            assert a.pool_tokens == a.unique + a.pad_slack + a.frag_slack
            assert a.live == TF.expected_len(seq, got.mix)
            assert TP.pool_blocks(seq, got) == RP.pool_blocks(seq, ref)


FLEET = dict(arch=("llava15-7b", "llama3.2-3b"), chips=(4, 8),
             chip=("v5e", "h100"), kind="decode", global_batches=(4, 16),
             seq_lens=(1024, 4096), block_sizes=(0, 16),
             prefix_hit_rates=(0.0, 0.5), prefix_len=256)


def fleet_grid(module, fleet, assembly, mixes, drafts):
    parse = TF.parse_mix if module is SW else RF.parse_mix
    return module.SweepGrid(**dict(
        fleet, assembly=assembly,
        mixes=tuple(parse(m) if m else None for m in mixes),
        draft_archs=drafts))


@pytest.mark.parametrize("engine", ["torch", "numpy"])
@pytest.mark.parametrize("assembly", ["legacy", "liveness"])
@pytest.mark.parametrize("what,mixes,drafts", [
    ("mix", ("", "0.25:512x1,2048x3", "0.5"), ("",)),
    ("draft", ("",), ("", "smollm-360m", "llama3.2-3b")),
    ("mix-draft", ("", "0.25:512x1,2048x3"), ("", "smollm-360m")),
])
def test_mix_and_draft_grids_equal_reference(what, mixes, drafts, assembly,
                                             engine):
    """The serving-fleet grid crossing mixes and drafts: every column, the
    pool / draft / hit-savings provenance included, equals the reference's
    numpy engine on both port engines."""
    ref = RS.SweepEngine().sweep(fleet_grid(RS, FLEET, assembly, mixes,
                                            drafts))
    got = SW.SweepEngine().sweep(
        fleet_grid(SW, FLEET, assembly, mixes, drafts), engine=engine,
        **({"device": "cpu"} if engine == "torch" else {}))
    assert len(got) == len(ref) > 0
    for c in ("peak_bytes", "fits", "pool_bytes", "draft_bytes",
              "hit_saved_bytes", "srv_c", "overlap_slack_bytes"):
        a, b = getattr(got.columns, c), getattr(ref.columns, c)
        assert (a is None and b is None) or np.array_equal(a, b), c
    assert got.to_csv() == ref.to_csv()
    if "draft" in what:
        assert got.columns.draft_bytes.max() > 0
    if "mix" in what:
        # the mixes are serve-axis entries of their own, and the pool they
        # size is live
        assert len(got.grid.serve_specs()) > len(drafts)
        assert got.columns.pool_bytes.max() > 0
