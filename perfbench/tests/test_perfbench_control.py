"""The control at a size a test run holds: the reference with every
product's operands rounded to float8 e4m3 (the precision below the
configuration's bfloat16), put in the program's place, fails the cell's
limits on each of three seeds.  ``control.py`` reads the same at the
cell's own size on the card."""

import pytest

from perfbench import control
from perfbench.harness import check
from perfbench.tests import reduced


@pytest.mark.parametrize("name", reduced.CELLS)
def test_the_control_is_not_correct(name):
    cell = reduced.cell(name)
    for seed in (1, 2, 3):
        found = control.readings(cell, seed, "cpu", control=True,
                                 log=lambda *a, **k: None)
        ok, checks = check.judge(found["control"], cell.limits)
        assert not ok, (seed, checks)
        assert set(found["program"]) == set(check.NAMES)
