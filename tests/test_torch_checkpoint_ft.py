"""Port of the checkpointer (``repro_torch.checkpoint``) and the
fault-tolerant trainer (``repro_torch.runtime.fault_tolerance``) against
the reference package, on the CPU.

* round trips: fp32 / bf16 / int leaves, ``None`` leaves, lists, a shape
  mismatch refused, retention, the async save's host copy taken at the
  call, and a model's train state (parameters restored in place, the
  AdamW state and the step as new tensors);
* a checkpoint of a dict of arrays written by either package restores in
  the other, bit for bit, with the same paths in ``meta.json``;
* ``ResilientTrainer``'s history, ``restarts``, straggler events and
  shard rotation under the same injected failures and step times (a
  scripted clock) as the reference's trainer;
* a real reduced-model run interrupted and replayed from its checkpoint
  ends bit-equal to the uninterrupted run.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as RC
from repro.runtime import fault_tolerance as RFT
from repro_torch import checkpoint as TC
from repro_torch.configs import get_config
from repro_torch.core.spec import FULL_TRAIN
from repro_torch.models import build_model
from repro_torch.runtime import fault_tolerance as TFT
from repro_torch.train import OptimizerConfig, make_train_step, train_state


def np_tree(seed: int = 0) -> dict:
    """A nested dict of numpy arrays: fp32, bf16, int32, a list and a
    ``None`` leaf."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "blocks": {"scale": rng.standard_normal(5).astype(jnp.bfloat16),
                       "idx": np.arange(6, dtype=np.int32).reshape(2, 3)},
            "stack": [rng.standard_normal(2).astype(np.float32), None],
            "step": np.asarray(7, np.int32)}


def to_torch_tree(tree):
    if isinstance(tree, dict):
        return {k: to_torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch_tree(v) for v in tree]
    if tree is None:
        return None
    a = np.array(tree, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def jax_tree(tree):
    return jax.tree.map(lambda a: None if a is None else jnp.asarray(a),
                        tree, is_leaf=lambda x: x is None)


def bits(x) -> np.ndarray:
    """A leaf's bytes, whichever package made it."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return t.reshape(-1).view(torch.uint8).numpy().copy()
    return np.frombuffer(np.ascontiguousarray(np.asarray(x)).tobytes(),
                         np.uint8)


def assert_same_tree(got, want):
    assert type(got) is type(want) or (got is None) == (want is None)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_tree(g, w)
    elif want is not None:
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).removeprefix("torch.") == \
            str(want.dtype).removeprefix("torch.")
        assert np.array_equal(bits(got), bits(want))


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------


def test_round_trip_keeps_every_leaf_bit_for_bit(tmp_path):
    tree = to_torch_tree(np_tree())
    path = TC.save_checkpoint(str(tmp_path), 3, tree, extra={"note": "x"})
    assert os.path.basename(path) == "step_3"
    assert TC.latest_step(str(tmp_path)) == 3
    got = TC.load_checkpoint(str(tmp_path), 3, like=tree)
    assert_same_tree(got, tree)
    assert got["stack"][1] is None
    assert got["blocks"]["scale"].dtype == torch.bfloat16
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["extra"] == {"note": "x"} and meta["step"] == 3
    # a like leaf of None takes the stored leaf (on the host)
    like = dict(tree, w=None)
    assert torch.equal(TC.load_checkpoint(str(tmp_path), 3, like)["w"],
                       tree["w"])
    assert TC.latest_step(str(tmp_path / "missing")) is None


def test_shape_mismatch_raises(tmp_path):
    tree = to_torch_tree(np_tree())
    TC.save_checkpoint(str(tmp_path), 1, tree)
    bad = dict(tree, w=torch.zeros(4, 3))
    with pytest.raises(ValueError, match="shape mismatch at \\['w'\\]"):
        TC.load_checkpoint(str(tmp_path), 1, like=bad)


def test_retention_and_async_snapshot(tmp_path):
    ck = TC.Checkpointer(str(tmp_path), keep=2)
    t = torch.zeros(4)
    for step in range(1, 5):
        t.fill_(step)
        ck.save_async(step, {"t": t})
        t.fill_(-1.0)              # after the call: the save holds `step`
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]
    step, got = ck.restore_latest(like={"t": t})
    assert step == 4 and torch.equal(got["t"], torch.full((4,), 4.0))
    assert TC.Checkpointer(str(tmp_path / "none")).restore_latest(
        {"t": t}) == (None, None)


def test_async_write_errors_surface_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = TC.Checkpointer(str(blocker))
    ck.save_async(1, {"t": torch.ones(2)})
    with pytest.raises(OSError):
        ck.wait()


def test_train_state_round_trip_restores_parameters_in_place(tmp_path):
    model = build_model(get_config("smollm-360m").reduced())
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    state = train_state(params, FULL_TRAIN, OptimizerConfig(name="adamw"))
    TC.save_checkpoint(str(tmp_path), 2, state)
    saved = {n: p.detach().clone() for n, p in params.named_parameters()}
    opt_saved = {k: {n: v.clone() for n, v in d.items()}
                 for k, d in state.opt.items()}
    with torch.no_grad():
        for p in params.parameters():
            p.add_(1.0)
    for d in state.opt.values():
        for v in d.values():
            v.add_(1.0)
    got = TC.load_checkpoint(str(tmp_path), 2, like=state)
    assert got.params is params                       # in place
    for n, p in params.named_parameters():
        assert torch.equal(p, saved[n]), n
    for k, d in got.opt.items():
        for n, v in d.items():
            assert torch.equal(v, opt_saved[k][n]), (k, n)
            assert v is not state.opt[k][n]
    assert got.step.dtype == torch.int32 and int(got.step) == 0
    meta = json.load(open(tmp_path / "step_2" / "meta.json"))
    paths = [m["path"] for m in meta["leaves"]]
    assert ".params/['language_model']/['blocks']/['0']/['attn']/['wq']" \
        in paths
    assert ".step" in paths


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = np_tree(1)
    RC.save_checkpoint(str(tmp_path), 5, jax_tree(tree))
    got = TC.load_checkpoint(str(tmp_path), 5, like=to_torch_tree(tree))
    assert_same_tree(got, to_torch_tree(tree))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = np_tree(2)
    TC.save_checkpoint(str(tmp_path / "port"), 6, to_torch_tree(tree))
    like = jax_tree(tree)
    got = RC.load_checkpoint(str(tmp_path / "port"), 6, like=like)
    assert_same_tree(jax.tree.map(
        lambda a: None if a is None else np.asarray(a), got,
        is_leaf=lambda x: x is None), tree)
    # the same tree written by both packages: the same paths, dtypes and
    # shapes, leaf for leaf
    RC.save_checkpoint(str(tmp_path / "ref"), 6, like)
    metas = [json.load(open(tmp_path / d / "step_6" / "meta.json"))
             for d in ("port", "ref")]
    assert metas[0]["leaves"] == metas[1]["leaves"]


# ---------------------------------------------------------------------------
# the trainer, against the reference's
# ---------------------------------------------------------------------------


class Clock:
    """A scripted ``time.monotonic``: each train step advances it by the
    next of ``durations``."""

    def __init__(self, durations):
        self.t, self.durations = 0.0, list(durations)

    def monotonic(self):
        return self.t

    def step(self):
        self.t += self.durations.pop(0) if self.durations else 1.0


class Pipe:
    def __init__(self, n_shards=4, shard_id=2):
        self.n_shards, self.shard_id = n_shards, shard_id


def run_trainer(pkg, tmp_path, monkeypatch, injector, durations,
                n_steps=12, ckpt_every=10 ** 6, max_restarts=3,
                pipeline=None, pilot=None):
    """One package's ResilientTrainer over an integer state (a 0-d int32:
    the reference restores only leaves with a shape) whose loss is the
    state: (state, history, trainer) or the exception it raised."""
    FT, CK = (RFT, RC) if pkg == "ref" else (TFT, TC)
    clock = Clock(durations)
    monkeypatch.setattr(FT, "time", clock)

    def step(state, batch):
        clock.step()
        return state + 1, {"loss": state + 0.5}
    trainer = FT.ResilientTrainer(
        train_step=step, pipeline=pipeline,
        checkpointer=CK.Checkpointer(str(tmp_path / pkg)),
        fault_cfg=FT.FaultConfig(ckpt_every=ckpt_every,
                                 max_restarts=max_restarts),
        make_batch=lambda s: None, failure_injector=injector,
        autopilot=pilot, memory_source=(lambda s: 1000 + s) if pilot
        else None)
    try:
        state, history = trainer.run(np.int32(0), 0, n_steps)
    except RuntimeError as e:
        return None, str(e), trainer
    return int(state), history, trainer


def once(steps, times=1):
    left = {s: times for s in steps}

    def injector(step):
        if left.get(step, 0) > 0:
            left[step] -= 1
            return True
        return False
    return injector


SCRIPTS = {
    # (injector factory, step durations, n_steps, ckpt_every, max_restarts)
    "sporadic": (lambda: once(range(0, 12, 2)), [1.0] * 30, 12, 10 ** 6, 3),
    "streak_aborts": (lambda: (lambda s: s == 4), [1.0] * 30, 10, 10 ** 6,
                      2),
    "two_then_ok": (lambda: once([3], 2), [1.0] * 30, 6, 10 ** 6, 2),
    "restore_replay": (lambda: once([5]), [1.0] * 30, 8, 2, 3),
    "stragglers": (lambda: once([]), [1.0, 1.0, 5.0, 1.0, 9.0, 1.0, 1.0,
                                      30.0, 1.0, 1.0], 10, 3, 3),
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_trainer_matches_the_reference(script, tmp_path, monkeypatch):
    make_inj, durations, n, every, budget = SCRIPTS[script]
    out = {}
    for pkg in ("ref", "port"):
        pipe = Pipe()
        state, history, tr = run_trainer(
            pkg, tmp_path, monkeypatch, make_inj(), durations, n_steps=n,
            ckpt_every=every, max_restarts=budget, pipeline=pipe)
        out[pkg] = (state, history, tr.restarts, tr._consecutive_failures,
                    tr.straggler_events, pipe.shard_id)
    assert out["port"] == out["ref"]
    if script == "restore_replay":     # the step-4 checkpoint replayed
        steps = [h["step"] for h in out["port"][1]]
        assert steps == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    if script == "stragglers":
        assert out["port"][4]
    if script == "streak_aborts":
        assert out["port"][0] is None and "injected failure" in \
            out["port"][1]


def test_trainer_admission_control_matches_the_reference(tmp_path,
                                                         monkeypatch):
    """The memory hook observes BEFORE each step and on_restart fires on
    every recovered failure, in both packages alike."""
    calls = {}
    for pkg in ("ref", "port"):
        seen = calls[pkg] = {"observe": [], "restart": []}

        class StubPilot:
            def observe(self, step, obs, seen=seen):
                seen["observe"].append((step, obs))

            def on_restart(self, step=-1, mesh_shape=None, seen=seen):
                seen["restart"].append(step)
        run_trainer(pkg, tmp_path, monkeypatch, once([2]), [1.0] * 10,
                    n_steps=4, pilot=StubPilot())
    assert calls["port"] == calls["ref"]
    assert calls["port"]["restart"] == [2]
    assert len(calls["port"]["observe"]) == 5


def test_rescale_matches_the_reference(tmp_path):
    out = {}
    for pkg, FT, CK in (("ref", RFT, RC), ("port", TFT, TC)):
        pipe, restarts = Pipe(n_shards=8, shard_id=7), []

        class StubPilot:
            def on_restart(self, step=-1, mesh_shape=None):
                restarts.append(step)
        tr = FT.ResilientTrainer(
            train_step=None, pipeline=pipe,
            checkpointer=CK.Checkpointer(str(tmp_path / pkg)),
            autopilot=StubPilot())
        tr.rescale(4)
        out[pkg] = (pipe.n_shards, pipe.shard_id, restarts)
    assert out["port"] == out["ref"] == (4, 3, [-1])


# ---------------------------------------------------------------------------
# a real model's run, interrupted and replayed
# ---------------------------------------------------------------------------


def test_interrupted_run_replays_bit_equal(tmp_path):
    """The reduced smollm-360m, 6 AdamW steps, a checkpoint every 2, a
    failure injected at step 5: the trainer restores the step-4
    checkpoint (parameters, AdamW state, step), replays step 4, and ends
    with the losses and the parameters of the uninterrupted run."""
    model = build_model(get_config("smollm-360m").reduced())
    opt = OptimizerConfig(name="adamw")
    step_fn = make_train_step(model, FULL_TRAIN, opt, remat="block")

    def batch(step):
        g = torch.Generator().manual_seed(100 + step)
        t = torch.randint(0, model.cfg.vocab, (2, 16), generator=g,
                          dtype=torch.int32)
        return {"tokens": t, "labels": t.roll(-1, dims=1)}

    def fresh():
        return train_state(model.init(torch.Generator().manual_seed(0),
                                      "cpu"), FULL_TRAIN, opt)
    state = fresh()
    straight = []
    for s in range(6):
        state, metrics = step_fn(state, batch(s))
        straight.append(float(metrics["loss"]))
    want = {n: p.detach().clone() for n, p in state.params.named_parameters()}

    tr = TFT.ResilientTrainer(
        train_step=step_fn, pipeline=None,
        checkpointer=TC.Checkpointer(str(tmp_path), keep=2),
        fault_cfg=TFT.FaultConfig(ckpt_every=2), make_batch=batch,
        failure_injector=once([5]))
    state, history = tr.run(fresh(), 0, 6)
    assert tr.restarts == 1
    assert [h["step"] for h in history] == [0, 1, 2, 3, 4, 4, 5]
    assert [h["loss"] for h in history] == straight[:5] + straight[4:]
    assert int(state.step) == 6
    for n, p in state.params.named_parameters():
        assert torch.equal(p, want[n]), n
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_6"]
