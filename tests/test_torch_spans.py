"""``device_metrics.span`` and ``SpanRecorder``: off, a span is one shared
do-nothing context; under the profiler a step of each benchmark cell (at
the size ``perfbench/tests/reduced.py`` cuts it to) emits every program
span, nested as the step runs; a recorder keeps the phase spans alone,
with the allocator's readings None off CUDA."""

import itertools
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.harness import train
from perfbench.tests import reduced
from repro_torch.core import device_metrics as DM

PHASES = ["repro_torch.train.forward", "repro_torch.train.backward",
          "repro_torch.train.optimizer"]
OPS = ["repro_torch.ops.flash_attention.fwd",
       "repro_torch.ops.flash_attention.bwd",
       "repro_torch.ops.rmsnorm.fwd", "repro_torch.ops.rmsnorm.bwd"]
BLOCK, CHUNK = "repro_torch.model.block", "repro_torch.model.loss_chunk"


def _program(name, remat="block"):
    cell = reduced.cell(name, "float32")
    cell.config["training"]["remat"] = remat
    c = train.Cell(cell, 3, "cpu")
    prog, _ = c.program()
    return c, prog


def _no_record_function(*args, **kwargs):
    raise AssertionError("record_function called with tracing off")


def test_a_span_off_is_one_shared_context(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function",
                        _no_record_function)
    off = DM.span("repro_torch.a")
    assert off is DM.span("repro_torch.b", phase=True)

    def run(n):
        for _ in itertools.repeat(None, n):
            with DM.span("repro_torch.a"):
                pass
            with DM.span("repro_torch.b", phase=True):
                pass
    run(10)
    tracemalloc.start()
    try:
        run(10_000)
        current, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert current == 0


def test_an_untraced_step_opens_no_range(monkeypatch):
    c, prog = _program("vlm_stage1_8x2k")
    monkeypatch.setattr(torch.profiler, "record_function",
                        _no_record_function)
    assert torch.isfinite(prog.run(c.batch(0)))


def _spans(prof):
    return [(float(e.time_range.start), float(e.time_range.end), e.name)
            for e in prof.events() if e.name.startswith(DM.SPAN_PREFIX)]


def _inside(spans, name, outer):
    """The spans named ``name`` that lie within a span named ``outer``."""
    outs = [(a, b) for a, b, n in spans if n == outer]
    return [(a, b) for a, b, n in spans if n == name
            and any(oa <= a and b <= ob for oa, ob in outs)]


@pytest.mark.parametrize("name,blocks", [("vlm_stage1_8x2k", 2),
                                         ("speech_full_4x2k", 4)])
def test_a_profiled_step_emits_every_span_nested(name, blocks):
    c, prog = _program(name)
    prog.run(c.batch(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prog.run(c.batch(1))
    spans = _spans(prof)
    names = {n for _, _, n in spans}
    assert names == set(PHASES + OPS + [BLOCK, CHUNK])
    fwd, bwd = PHASES[0], PHASES[1]
    assert [n for _, _, n in spans].count(fwd) == 1
    # every block runs in the forward and again (remat) in the backward
    assert len(_inside(spans, BLOCK, fwd)) == blocks
    assert len(_inside(spans, BLOCK, bwd)) == blocks
    assert len(_inside(spans, CHUNK, fwd)) == len(_inside(spans, CHUNK, bwd))
    # the attention runs inside the blocks, forward and recompute; its
    # backward and the norms' inside the step's backward
    assert len(_inside(spans, OPS[0], BLOCK)) == \
        [n for _, _, n in spans].count(OPS[0])
    assert _inside(spans, OPS[1], bwd) and \
        len(_inside(spans, OPS[3], bwd)) == \
        [n for _, _, n in spans].count(OPS[3])
    assert len(_inside(spans, OPS[2], BLOCK)) >= 2 * 2 * blocks
    assert not _inside(spans, fwd, bwd) and not _inside(spans, bwd, fwd)


@pytest.mark.parametrize("policy,reruns", [("none", 0), ("block", 1),
                                           ("dots", 1)])
def test_every_remat_policy_spans_its_blocks(policy, reruns):
    c, prog = _program("vlm_stage1_8x2k", policy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss = prog.run(c.batch(0))
    spans = _spans(prof)
    assert len(_inside(spans, BLOCK, PHASES[0])) == 2
    assert len(_inside(spans, BLOCK, PHASES[1])) == 2 * reruns
    assert torch.isfinite(loss)


def test_the_recorder_keeps_the_phases_alone():
    with DM.SpanRecorder("cpu") as rec:
        c, prog = _program("speech_full_4x2k")
    assert [r.name for r in rec.records] == ["repro_torch.train.state"]
    with DM.SpanRecorder("cpu") as rec:
        prog.run(c.batch(0))
    assert [r.name for r in rec.records] == PHASES
    for r in rec.records:
        assert r.parent is None and r.seconds > 0
        # off CUDA the allocator's readings are absent, never 0
        assert r.allocated_in is r.allocated_out is r.peak_out is None
        assert not any(isinstance(v, torch.Tensor) for v in vars(r).values())
    assert DM._RECORDERS == []


def test_a_nested_phase_names_its_parent():
    with DM.SpanRecorder("cpu") as rec:
        with DM.span("repro_torch.outer", phase=True):
            with DM.span("repro_torch.inner", phase=True):
                pass
            with DM.span("repro_torch.op"):
                pass
    assert [(r.name, r.parent) for r in rec.records] == [
        ("repro_torch.inner", "repro_torch.outer"),
        ("repro_torch.outer", None)]

