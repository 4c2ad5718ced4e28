"""The training launcher (``python -m repro_torch.launch.train``) against
the reference's (``python -m repro.launch.train``), on the CPU.

* ``--check-only`` prints exactly the reference's planner report, for
  three archs on the default (16, 16) mesh (the reference run as its own
  process, as a user runs it);
* the OoM guard refuses a doomed job with the reference's message, before
  anything is built;
* ``--reduced --device cpu --steps 3`` trains, and its loss history is the
  reference's flow on the same (carried) weights and the same pipeline
  batches, step for step within 1e-4 relative (the bf16 spread between
  the two is about 5e-6), while the steps move the loss by more than 5
  times that; after the 3 steps every leaf's first moment is the
  reference's within 2^-5 of its scale and every fp32 master's updates
  are the reference's within 0.15 of their norm;
* in a world of 4 gloo processes ``--data 2`` builds the (2, 2) mesh and
  trains with ZeRO shardings: its loss history is the one-process run's
  within the same 1e-4, and its optimizer state after 3 steps that run's
  (m and v within 2^-4 of each leaf's scale, the masters' updates within
  0.15 of their norm);
* with no card and no ``--device cpu`` the launcher raises.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.runtime import fault_tolerance as RFT
from repro_torch import train as TT
from repro_torch.configs import get_config
from repro_torch.core.spec import FULL_TRAIN
from repro_torch.models import build_model
from repro_torch.launch import train as LT
from tests.test_torch_sharded_train import spawn_ranks

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_RTOL = 1e-4


def reference_cli(*argv: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "repro.launch.train",
                           *argv], capture_output=True, text=True, env=env,
                          timeout=300)


@pytest.mark.parametrize("arch", ["llava15-7b", "smollm-360m",
                                  "deepseek-v2-lite-16b"])
def test_check_only_prints_the_reference_report(arch, capsys):
    want = reference_cli("--arch", arch, "--shape", "train_4k",
                         "--check-only")
    assert want.returncode == 0, want.stderr
    out = LT.main(["--arch", arch, "--shape", "train_4k", "--check-only"])
    assert capsys.readouterr().out == want.stdout
    assert out.state is None and str(out.report) == want.stdout.strip()


def test_guard_refuses_a_doomed_job_with_the_reference_message(capsys):
    argv = ["--arch", "arctic-480b", "--shape", "train_4k", "--data", "1",
            "--model", "1"]
    want = reference_cli(*argv)
    assert want.returncode == 1
    with pytest.raises(SystemExit) as err:
        LT.main(argv)
    assert str(err.value) == want.stderr.strip().splitlines()[-1]
    assert capsys.readouterr().out == want.stdout


def test_reduced_run_follows_the_reference_flow(tmp_path, monkeypatch):
    argv = ["--arch", "smollm-360m", "--reduced", "--steps", "3"]
    # the reference's flow, in this process
    ref_hist, ref_state = [], []
    run = RFT.ResilientTrainer.run

    def keep(self, *a, **k):
        state, history = run(self, *a, **k)
        ref_hist.extend(history)
        ref_state.append(state)
        return state, history

    monkeypatch.setattr(RFT.ResilientTrainer, "run", keep)
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--ckpt-dir",
                                      str(tmp_path / "ref")])
    from repro.launch import train as RT
    RT.main()
    # the port's, on the reference's weights (its init draws from JAX's
    # generator, the port's from torch's)
    ref_params = jax.tree.map(np.asarray, ref_build(
        ref_config("smollm-360m").reduced()).init(jax.random.PRNGKey(0)))

    def carried(model, policy, opt_cfg, generator, device="cuda"):
        return TT.train_state(model.from_numpy(ref_params, device), policy,
                              opt_cfg)

    monkeypatch.setattr(TT, "init_train_state", carried)
    out = LT.main(argv + ["--device", "cpu", "--ckpt-dir",
                          str(tmp_path / "port")])
    assert [h["step"] for h in out.history] == [0, 1, 2] \
        == [h["step"] for h in ref_hist]
    losses = [h["loss"] for h in out.history]
    np.testing.assert_allclose(losses, [h["loss"] for h in ref_hist],
                               rtol=LOSS_RTOL)
    # the steps moved the loss by far more than that
    assert min(abs(x - losses[0]) for x in losses[1:]) \
        > 5 * LOSS_RTOL * losses[0]
    assert int(out.state.step) == 3 and len(out.step_s) == 3
    # every leaf's state after three steps against the reference's: the
    # first moment (three steps of bf16 gradients) within 2^-5 of its
    # scale, and the fp32 master's three updates within 0.15 of their
    # norm (a sign of g that bf16 rounds apart moves an element by 2 lr)
    for leaf, st in out.state.opt.items():
        want = ref_leaf(ref_state[0].opt, leaf)
        m = want["m"]
        assert np.abs(st["m"].numpy() - m).max() <= 2.0 ** -5 * \
            np.abs(m).max(), leaf
        init = ref_leaf(ref_params, leaf)
        moved = np.linalg.norm(want["master"] - init)
        assert np.linalg.norm(st["master"].numpy() - want["master"]) \
            <= 0.15 * moved, leaf
    # the trainer's final checkpoint holds the step count
    assert os.path.isdir(tmp_path / "port" / "step_3")


def ref_leaf(tree, leaf: str):
    """The reference's leaf (or its state) at the port's dotted name, as
    fp32 numpy."""
    for k in leaf.split("."):
        tree = tree[k]
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_no_card_and_no_host_request_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        LT.main(["--arch", "smollm-360m", "--reduced", "--steps", "1",
                 "--ckpt-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


LAUNCH_RANK = r"""
import json, os
from datetime import timedelta
import numpy as np
import torch.distributed as dist

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
out_dir = os.environ["OUT"]
dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=60))
try:
    from repro_torch.launch import train as LT
    out = LT.main(ARGV + ["--data", "2", "--ckpt-dir",
                          os.path.join(out_dir, "ckpt")])
    state = {f"{leaf}/{k}": t.full_tensor().numpy()
             for leaf, st in out.state.opt.items() for k, t in st.items()}
    if rank == 0:
        np.savez(os.path.join(out_dir, "launch_state.npz"), **state)
        with open(os.path.join(out_dir, "launch.json"), "w") as f:
            json.dump({"history": out.history,
                       "step": int(out.state.step)}, f)
    print("LAUNCH_OK", rank)
finally:
    dist.destroy_process_group()
"""


def test_four_process_run_follows_the_one_process_run(tmp_path):
    """``main`` in a world of 4 gloo processes (the group the caller
    started): it builds the (2, 2) ``data, model`` mesh from ``--data 2``,
    places the state and the batches and trains with ZeRO shardings.  Its
    loss history and its optimizer state after 3 steps against one
    process's run from the same seed."""
    argv = ["--arch", "smollm-360m", "--reduced", "--steps", "3",
            "--device", "cpu"]
    one = LT.main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    outs = spawn_ranks(f"ARGV = {argv!r}\n" + LAUNCH_RANK, tmp_path)
    assert all("LAUNCH_OK" in o for o in outs)
    assert all("mesh={'data': 2, 'model': 2}" in o for o in outs)
    info = json.loads((tmp_path / "launch.json").read_text())
    got = np.load(tmp_path / "launch_state.npz")
    losses = [h["loss"] for h in info["history"]]
    assert [h["step"] for h in info["history"]] == [0, 1, 2]
    np.testing.assert_allclose(losses, [h["loss"] for h in one.history],
                               rtol=LOSS_RTOL)
    assert min(abs(x - losses[0]) for x in losses[1:]) \
        > 5 * LOSS_RTOL * losses[0]
    assert info["step"] == 3
    # the optimizer state after 3 steps: m and v (three steps of bf16
    # gradients, each rounded on the ranks before their average) within
    # 2^-4 of each leaf's scale, the fp32 master's three updates within
    # 0.15 of their norm
    cfg = get_config("smollm-360m").reduced()
    gen = torch.Generator().manual_seed(0)
    init = TT.init_train_state(build_model(cfg), FULL_TRAIN,
                               TT.OptimizerConfig(), gen, "cpu")
    for leaf, st in one.state.opt.items():
        for k in ("m", "v"):
            want = st[k].numpy()
            assert np.abs(got[f"{leaf}/{k}"] - want).max() \
                <= 2.0 ** -4 * np.abs(want).max(), (leaf, k)
        want = st["master"].numpy()
        moved = np.linalg.norm(want - init.opt[leaf]["master"].numpy())
        assert np.linalg.norm(got[f"{leaf}/master"] - want) \
            <= 0.15 * moved, leaf
