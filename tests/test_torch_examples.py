"""The five examples of the port (``python -m repro_torch.examples.<name>``)
against the reference's scripts (``examples/*.py``, run by ``runpy`` with
``sys.argv`` set), on the CPU: every line the predictor prints is the
reference's; the runs that do not print predictor numbers (sweep times,
the generated tokens, the losses) are held to their own invariants."""

from __future__ import annotations

import math
import re
import runpy
import sys
import tempfile
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def reference(name: str, argv: list, capsys, monkeypatch, tmp_path) -> str:
    """The reference script's standard output."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    runpy.run_path(str(REPO / "examples" / f"{name}.py"),
                   run_name="__main__")
    return capsys.readouterr().out


def port(name: str, argv: list, capsys):
    """(what the port's ``main`` returned, its standard output)."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    capsys.readouterr()
    ret = mod.main(argv)
    return ret, capsys.readouterr().out


def test_quickstart_prints_the_reference(capsys, monkeypatch, tmp_path):
    want = reference("quickstart", [], capsys, monkeypatch, tmp_path)
    rc, got = port("quickstart", [], capsys)
    assert rc == 0 and got == want
    assert "accum x8" in got


def _untimed(text: str) -> str:
    """The sweep lines without their times."""
    return re.sub(r" in \d+ ms.*", " in <t>", text)


def test_capacity_plan_prints_the_reference(capsys, monkeypatch, tmp_path):
    want = reference("capacity_plan", [], capsys, monkeypatch, tmp_path)
    rc, got = port("capacity_plan", ["--device", "cpu"], capsys)
    assert rc == 0 and _untimed(got) == _untimed(want)
    assert "min chips for batch 256" in got


@pytest.mark.parametrize("argv", [
    [], ["--arch", "qwen3-32b"],
    ["--arch", "llava15-7b", "--policy", "llava_stage1", "--data", "8",
     "--model", "2", "--grad-accum", "4", "--backend", "cpu"],
    ["--arch", "smollm-360m", "--shape", "long_500k", "--data", "1",
     "--model", "1", "--hbm-gib", "80"],
    ["--arch", "deepseek-v2-lite-16b", "--shape", "prefill_32k"]],
    ids=["default", "qwen", "llava_stage1_cpu", "smollm_long", "deepseek"])
def test_predict_memory_prints_the_reference(argv, capsys, monkeypatch,
                                             tmp_path):
    want = reference("predict_memory", argv, capsys, monkeypatch, tmp_path)
    rc, got = port("predict_memory", argv, capsys)
    assert rc == 0 and got == want
    assert "verdict: " in got


@pytest.mark.parametrize("argv,why", [
    (["--validate"], "--data 1 --model 1"),
    (["--validate", "--data", "1", "--model", "1", "--grad-accum", "2"],
     "--grad-accum 1"),
    (["--validate", "--data", "1", "--model", "1"], "on the card")],
    ids=["mesh", "accum", "host"])
def test_predict_memory_validate_refuses_before_predicting(argv, why,
                                                           capsys,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        port("predict_memory", argv, capsys)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert why in err


def test_predict_memory_validate_guards_a_doomed_cell(capsys, monkeypatch):
    """smollm-360m at 524,288 positions is 21.45 GiB: over a 16 GiB chip's
    budget, refused with the launcher's guard before any allocation (as
    it would be with a card present)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit) as e:
        port("predict_memory", ["--arch", "smollm-360m", "--shape",
                                "long_500k", "--data", "1", "--model", "1",
                                "--validate"], capsys)
    assert str(e.value.code).startswith(
        "OoM guard: refusing to launch a doomed job")
    assert not torch.cuda.is_initialized()


def test_serve_batched(capsys, monkeypatch, tmp_path):
    want = reference("serve_batched", [], capsys, monkeypatch, tmp_path)
    out, got = port("serve_batched", ["--device", "cpu"], capsys)
    admission = [ln for ln in want.splitlines() if "admission:" in ln]
    assert len(admission) == 3
    assert [ln for ln in got.splitlines() if "admission:" in ln] == admission
    tokens = out["tokens"]
    assert tuple(tokens.shape) == (4, 16)
    assert int(tokens.min()) >= 0 and int(tokens.max()) < out["vocab"]
    assert got.count("generated [") == 4


def test_train_llava_e2e(capsys, monkeypatch, tmp_path):
    argv = ["--steps", "3", "--batch", "2", "--seq", "80"]
    want = reference("train_llava_e2e", argv[:1] + ["1"] + argv[2:], capsys,
                     monkeypatch, tmp_path)
    out, got = port("train_llava_e2e", argv + ["--device", "cpu",
                                               "--ckpt-dir",
                                               str(tmp_path / "ckpt")],
                    capsys)
    # the prediction and the model line, up to the training loop's output
    head = want.split("\nloss ")[0].splitlines()
    assert got.splitlines()[:len(head)] == head
    assert head[0].startswith("predicted peak memory: ")
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert (tmp_path / "ckpt" / "step_3").is_dir()


@pytest.mark.parametrize("name", ["capacity_plan", "serve_batched",
                                  "train_llava_e2e"])
def test_device_defaults_to_the_card(name, capsys):
    """Without ``--device cpu`` and without a card, a device example exits
    2 before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        port(name, [], capsys)
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["quickstart"], ["capacity_plan", "--device", "cpu"],
    ["predict_memory", "--arch", "qwen3-32b"],
    ["serve_batched", "--device", "cpu"],
    ["train_llava_e2e", "--steps", "1", "--batch", "2", "--seq", "80",
     "--device", "cpu"]], ids=lambda a: a[0])
def test_runs_as_a_module(argv, tmp_path):
    """``python -m repro_torch.examples.<name>`` in a fresh interpreter on
    the CPU: exit 0."""
    import os
    import subprocess
    if argv[0] == "train_llava_e2e":
        argv = argv + ["--ckpt-dir", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m",
                        f"repro_torch.examples.{argv[0]}"] + argv[1:],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip()
