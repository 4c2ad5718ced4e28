"""The port's data pipeline (``repro_torch.data.SyntheticPipeline``) and
the trainer driving it, against the reference's, on the CPU.

* ``shard_batch`` / ``global_batch`` are bit-equal to the reference's for
  every branch — tokens / labels (a dense arch), ``patches`` (llava15-7b's
  vision tower), ``patch_embeds`` (llava-next-mistral-7b), ``frames``
  (seamless-m4t-large-v2) — over several (step, n_shards, shard_id), on
  the reduced and the published configs;
* restart safety and elastic repartition, as the reference's own tests
  (``tests/test_checkpoint_data_ft.py``);
* ``ResilientTrainer`` driving a pipeline object (its batches from
  ``global_batch(step)``) under the same injected step times (a scripted
  clock), a failure and a ``rescale``: the batches it fed, its straggler
  events, the rotated ``shard_id`` and the rescaled ``n_shards`` equal the
  reference's.
"""

import hashlib

import numpy as np
import pytest

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import ShapeConfig as RefShape
from repro.configs import get_config as ref_config
from repro.data import SyntheticPipeline as RefPipeline
from repro.runtime import fault_tolerance as RFT
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import SyntheticPipeline
from repro_torch.runtime import fault_tolerance as TFT
from tests.test_torch_checkpoint_ft import Clock

ARCHS = ["smollm-360m", "llava15-7b", "llava-next-mistral-7b",
         "seamless-m4t-large-v2"]
# (step, n_shards, shard_id)
CUTS = [(0, 1, 0), (7, 2, 1), (12345, 4, 3), (2 ** 40 + 5, 8, 0)]


def pair(arch: str, reduced: bool, seq: int, batch: int, **kw):
    rc, tc = ref_config(arch), get_config(arch)
    if reduced:
        rc, tc = rc.reduced(), tc.reduced()
    return (RefPipeline(rc, RefShape("t", seq, batch, "train"), **kw),
            SyntheticPipeline(tc, ShapeConfig("t", seq, batch, "train"),
                              **kw))


def assert_same_batch(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_the_reference(arch, reduced):
    # published widths at a short sequence (llava's 576 image tokens leave
    # it one text token, as the reference's max(S - n_img, 1))
    seq = 64 if reduced else 640
    for step, n, sid in CUTS:
        ref, port = pair(arch, reduced, seq, 8, n_shards=n, shard_id=sid)
        got = port.shard_batch(step)
        assert_same_batch(got, ref.shard_batch(step))
        assert got["tokens"].shape[0] == 8 // n
        assert_same_batch(port.global_batch(step), ref.global_batch(step))
        assert (port.n_shards, port.shard_id) == (n, sid)
    want = {"smollm-360m": {"tokens", "labels"},
            "llava15-7b": {"tokens", "labels", "patches"},
            "llava-next-mistral-7b": {"tokens", "labels", "patch_embeds"},
            "seamless-m4t-large-v2": {"tokens", "labels", "frames"}}[arch]
    assert set(got) == want


def test_pipeline_deterministic_and_restart_safe():
    cfg = get_config("smollm-360m").reduced()
    shape = ShapeConfig("t", 32, 8, "train")
    p1 = SyntheticPipeline(cfg, shape, n_shards=4, shard_id=2)
    a = p1.shard_batch(step=11)
    b = p1.shard_batch(step=11)        # same step -> identical
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = p1.shard_batch(step=12)        # different step -> different
    assert not np.array_equal(a["tokens"], c["tokens"])
    # a restarted pipeline (a new object) gives the same batch
    p2 = SyntheticPipeline(cfg, shape, n_shards=4, shard_id=2)
    np.testing.assert_array_equal(p2.shard_batch(11)["tokens"],
                                  a["tokens"])


def test_pipeline_elastic_repartition():
    """Re-sharding the pipeline keeps the global batch's shape and, for the
    same shard count, its content; the shards are the global batch's rows
    in order."""
    cfg = get_config("smollm-360m").reduced()
    shape = ShapeConfig("t", 32, 8, "train")
    g4 = SyntheticPipeline(cfg, shape, n_shards=4).global_batch(3)
    g2 = SyntheticPipeline(cfg, shape, n_shards=2).global_batch(3)
    g4b = SyntheticPipeline(cfg, shape, n_shards=4).global_batch(3)
    np.testing.assert_array_equal(g4["tokens"], g4b["tokens"])
    assert g2["tokens"].shape == g4["tokens"].shape
    for s in range(4):
        part = SyntheticPipeline(cfg, shape, n_shards=4,
                                 shard_id=s).shard_batch(3)
        np.testing.assert_array_equal(part["tokens"],
                                      g4["tokens"][2 * s:2 * s + 2])


def drive(pkg: str, tmp_path, monkeypatch) -> tuple:
    """One package's trainer over its own pipeline (4 shards, shard 1):
    step times 1 s but three slow steps, a failure at step 4 (no
    checkpoint yet: replayed from the start), then a rescale to 3 shards
    and two more steps."""
    FT, CK, (pipe, _) = (RFT, RefCheckpointer, pair(
        "smollm-360m", True, 16, 12, n_shards=4, shard_id=1)) \
        if pkg == "ref" else (TFT, Checkpointer, pair(
            "smollm-360m", True, 16, 12, n_shards=4, shard_id=1)[::-1])
    clock = Clock([1.0, 1.0, 5.0, 1.0, 1.0, 9.0, 1.0, 1.0, 30.0, 1.0,
                   1.0, 1.0])
    monkeypatch.setattr(FT, "time", clock)
    fed = []

    def step(state, batch):
        clock.step()
        fed.append(hashlib.sha256(batch["tokens"].tobytes()).hexdigest())
        return state + 1, {"loss": state + 0.5}

    failed = []
    trainer = FT.ResilientTrainer(
        train_step=step, pipeline=pipe,
        checkpointer=CK(str(tmp_path / pkg)),
        fault_cfg=FT.FaultConfig(ckpt_every=10 ** 6),
        failure_injector=lambda s: s == 4 and not failed
        and not failed.append(s))
    state, history = trainer.run(np.int32(0), 0, 8)
    rotated = pipe.shard_id
    trainer.rescale(3)
    state, more = trainer.run(state, 8, 2)
    return (fed, history + more, trainer.straggler_events, rotated,
            pipe.n_shards, pipe.shard_id, trainer.restarts)


def test_trainer_drives_the_pipeline_as_the_reference(tmp_path,
                                                      monkeypatch):
    ref = drive("ref", tmp_path, monkeypatch)
    port = drive("port", tmp_path, monkeypatch)
    assert port == ref
    fed, _, events, rotated, n, sid, restarts = port
    assert events and restarts == 1 and n == 3
    # every straggler rotated the shard onto the next (mod 4 before the
    # rescale, mod 3 after it, from the shard clamped into range)
    before = sum(e[0] < 8 for e in events)
    assert before == 2 and len(events) == 3
    assert rotated == (1 + before) % 4
    assert sid == (min(rotated, 2) + 1) % 3
    # each step was fed its global batch (4 shards, then 3)
    _, hist, *_ = port
    cfg, shape = get_config("smollm-360m").reduced(), \
        ShapeConfig("t", 16, 12, "train")
    assert fed == [hashlib.sha256(SyntheticPipeline(
        cfg, shape, n_shards=4 if h["step"] < 8 else 3).global_batch(
        h["step"])["tokens"].tobytes()).hexdigest() for h in hist]
