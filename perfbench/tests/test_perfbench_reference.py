"""The plain reference against the program's plain CPU path at a reduced
size, both in float32: the same weights and batches give the same losses,
first gradients and changes over three AdamW steps, to float32 rounding.
Only this test imports both sides."""

import pytest

from perfbench.harness import train
from perfbench.harness import check
from perfbench.tests import reduced


@pytest.mark.parametrize("name", reduced.CELLS)
def test_reference_follows_the_program_in_float32(name):
    c = train.Cell(reduced.cell(name, "float32"), 7, "cpu")
    prog, flat = c.program()
    got = c.checked_steps(prog)
    ref = c.reference()
    assert len(got["losses"]) == len(ref["losses"]) == \
        train.STEPS_CHECKED
    found = check.gaps(got, ref)
    assert found["loss_gap"] < 1e-5, found
    assert found["grad_gap"] < 1e-5, found
    assert found["change_gap"] < 1e-4, found
    assert set(got["grad1"]) == set(ref["grad1"])
    assert all(v > 0 for v in ref["change"].values())


def test_the_reference_tells_leaves_apart():
    """A leaf is one weight, or its stack over a stack's layers."""
    from perfbench.reference.common import leaf_of
    assert leaf_of("vlm.language_model.blocks.31.attn.wq") == \
        "vlm.language_model.blocks.attn.wq"
    assert leaf_of("vlm.projector.fc0.w") == "vlm.projector.fc0.w"
