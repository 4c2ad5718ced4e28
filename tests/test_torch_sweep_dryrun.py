"""The sweep CLI's ``--dry-run`` runtime line in the port against the
reference's ``core/sweep.py`` (``_rate_key``, ``_planning_rate``, the
printed lines), and the port's own rate keys for the torch engine."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import sweep as REF
from repro_torch.core import sweep as PORT

GRID = ["--arch", "llava15_7b", "--chips", "8,16", "--batch", "16,32",
        "--accum", "1,2", "--seq-len", "2048"]
PIPE = ["--arch", "deepseek_v2_lite_16b", "--chips", "16",
        "--mesh-axes", "data,model,expert,context,pipe", "--max-expert", "4",
        "--max-context", "2", "--max-pipe", "2", "--microbatches", "1,4",
        "--schedule", "1f1b,gpipe", "--batch", "32", "--seq-len", "4096"]


@pytest.fixture
def no_bench(tmp_path, monkeypatch):
    """Both packages' repo root is an empty directory: no BENCH_sweep.json."""
    import repro.calibrate.paths as ref_paths
    import repro_torch.calibrate.paths as port_paths
    monkeypatch.setattr(ref_paths, "repo_root", lambda: tmp_path)
    monkeypatch.setattr(port_paths, "repo_root", lambda: tmp_path)
    return tmp_path


@pytest.mark.parametrize("mode", ["columnar", "cell"])
@pytest.mark.parametrize("assembly", ["legacy", "liveness", None])
@pytest.mark.parametrize("engine", ["numpy", None])
def test_numpy_rate_keys_are_the_reference(mode, assembly, engine):
    assert PORT._rate_key(mode, engine, assembly) \
        == REF._rate_key(mode, engine, assembly)


@pytest.mark.parametrize("device,assembly,key", [
    ("cuda", "legacy", "columnar_torch"),
    (None, "legacy", "columnar_torch"),
    ("cuda", "liveness", "columnar_torch_liveness"),
    ("cpu", "legacy", "columnar_torch_cpu"),
    ("cpu", "liveness", "columnar_torch_cpu_liveness")])
def test_torch_rate_keys_name_the_device(device, assembly, key):
    assert PORT._rate_key("columnar", "torch", assembly, device) == key
    assert PORT._planning_rate("columnar", "torch", assembly,
                               device)[0] == 1_000_000


def test_numpy_planning_rates_are_the_reference(no_bench):
    for mode in ("columnar", "cell"):
        for assembly in ("legacy", "liveness"):
            assert PORT._planning_rate(mode, "numpy", assembly) \
                == REF._planning_rate(mode, "numpy", assembly)


def test_card_planning_rate_names_the_card(no_bench):
    rate, source = PORT._planning_rate("columnar", "torch", "legacy", "cuda")
    assert rate == 1_000_000
    assert source == "planning estimate (H100 80GB HBM3, 700 W)"
    assert "sweep_throughput" not in source
    _, host = PORT._planning_rate("columnar", "torch", "legacy", "cpu")
    assert "not measured" in host


def _lines(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    GRID, GRID + ["--assembly", "liveness"], GRID + ["--mode", "cell"],
    PIPE, PIPE + ["--assembly", "liveness"]],
    ids=["large", "large_liveness", "cell", "pipe", "pipe_liveness"])
def test_numpy_dry_run_lines_are_the_reference(argv, no_bench, capsys):
    argv = argv + ["--dry-run", "--engine", "numpy"]
    want = _lines(REF.main, argv, capsys)
    got = _lines(PORT.main, argv, capsys)
    assert got == want
    assert "estimated runtime in --mode" in got
    assert "planning estimate; run benchmarks/sweep_throughput.py" in got


def test_torch_dry_run_line(no_bench, capsys):
    out = _lines(PORT.main, GRID + ["--dry-run"], capsys)
    n = int(out.splitlines()[0].split()[2].replace(",", ""))
    assert out.splitlines()[-1] == (
        f"estimated runtime in --mode columnar --engine torch --assembly "
        f"legacy: ~{n / 1_000_000:.1f}s (1,000,000 cells/s — planning "
        f"estimate (H100 80GB HBM3, 700 W))")


def test_measured_rate_from_bench_file(no_bench, capsys):
    (no_bench / "BENCH_sweep.json").write_text(json.dumps({"modes": {
        "columnar_torch": {"cells_per_sec": 2_500_000.0},
        "columnar_torch_cpu_liveness": {"cells_per_sec": 40_000.0}}}))
    assert PORT._planning_rate("columnar", "torch", "legacy", "cuda") \
        == (2_500_000.0, "measured, BENCH_sweep.json")
    assert PORT._planning_rate("columnar", "torch", "liveness", "cpu") \
        == (40_000.0, "measured, BENCH_sweep.json")
    # another assembly or device never substitutes
    assert PORT._planning_rate("columnar", "torch", "liveness", "cuda")[1] \
        == "planning estimate (H100 80GB HBM3, 700 W)"
    out = _lines(PORT.main, GRID + ["--dry-run"], capsys)
    assert out.splitlines()[-1].endswith(
        "(2,500,000 cells/s — measured, BENCH_sweep.json)")
    out = _lines(PORT.main, GRID + ["--dry-run", "--device", "cpu",
                                    "--assembly", "liveness"], capsys)
    assert "(40,000 cells/s — measured, BENCH_sweep.json)" in out


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_dry_run_touches_no_device(no_bench, capsys):
    """No tensor operation of any kind runs (so nothing is allocated on
    any device) and CUDA is never initialised, with and without a card."""
    with _Ops() as mode:
        _lines(PORT.main, PIPE + ["--dry-run"], capsys)
        _lines(PORT.main, GRID + ["--dry-run", "--device", "cpu"], capsys)
    assert mode.ops == []
    assert not torch.cuda.is_initialized()
