"""A run of each cell driven on the CPU at a reduced size: the result
line's keys, and ``correct`` false under each fault the cell can have
planted under the timed path."""

import math
import time

import pytest

from perfbench.harness import train
from perfbench.harness import faults
from perfbench.tests import reduced


def _run(name, fault=None, trace=False, seed=2 ** 31 + 12345):
    return train.run(reduced.cell(name), seed, 0.2, trace, "cpu",
                     time.perf_counter(), fault=fault, log=lambda *a: None)


@pytest.mark.parametrize("name", reduced.CELLS)
def test_the_result_line(name):
    r = _run(name)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert isinstance(r["correct"], bool)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    cell = reduced.cell(name)
    assert "setup_s" in r["metrics"]
    for m in cell.end_to_end:
        if m["name"] != "peak_gib":          # no allocator on the CPU
            assert r["metrics"][m["name"]]["value"] > 0
            assert r["metrics"][m["name"]]["unit"] == m["unit"]
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
        assert math.isfinite(c["value"]) and c["limit"] > 0


@pytest.mark.parametrize("name", reduced.CELLS)
def test_a_traced_run_adds_the_per_layer_line(name):
    r = _run(name, trace=True)
    assert "busy_s" in r["device"] and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    cell = reduced.cell(name)
    assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
    if "mfu_pct" in [m["name"] for m in cell.per_layer]:
        assert r["metrics"]["mfu_pct"]["unit"] == "%"


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", reduced.CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(name, fault):
    r = _run(name, fault=fault)
    assert r["correct"] is False, r["checks"]
