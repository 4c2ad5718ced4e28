"""Port of the train step (repro_torch.train: ``train_state`` /
``make_train_step`` over ``Model.loss`` and the optimizers) against the
reference's jitted ``make_train_step``, on the CPU.

The reduced llava15-7b in fp32 (``dataclasses.replace(cfg,
dtype="float32")`` on both sides; the reference keeps the projector and
patch projection in bf16) with the reference's parameters carried across;
the step's batch is made with numpy from a seed.  Each test builds fresh
port parameters, because the port's step updates them in place.

Tolerances: metrics (loss, xent, grad_norm) within 1e-5 relative, except
the norm of int8-compressed gradients, 1e-3 (``round(g / scale)`` of a
gradient the two sides computed an ulp apart can land one step of the
int8 grid apart); updated fp32 leaves within 1e-4 of their scale; the
bf16 leaves within one bf16 ulp of their scale (the same master copy
rounded once on each side); frozen leaves bit-equal to their values
before the step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import spec as RSPEC
from repro.models import build_model as ref_build
from repro.train import optimizer as RO
from repro.train import train_step as RTS
from repro_torch.configs import get_config
from repro_torch.core.spec import FULL_TRAIN, LLAVA_STAGE1, LLAVA_STAGE2
from repro_torch.models import build_model
from repro_torch.models import param as TPM
from repro_torch.train import (OptimizerConfig, init_train_state,
                               make_train_step, train_state)
from tests.test_torch_train import ref_leaf, to_torch
from tests.test_torch_train import make_batch as _make_batch

POLICIES = {"full": (FULL_TRAIN, RSPEC.FULL_TRAIN),
            "llava_stage1": (LLAVA_STAGE1, RSPEC.LLAVA_STAGE1),
            "llava_stage2": (LLAVA_STAGE2, RSPEC.LLAVA_STAGE2)}
B = 4


def make_batch(model, seed: int = 1, batch: int = B):
    return _make_batch(model, seed=seed, batch=batch)


@pytest.fixture(scope="module")
def llava32():
    """(ref model, ref params as numpy, port model), llava15-7b fp32."""
    rcfg = dataclasses.replace(ref_config("llava15-7b").reduced(),
                               dtype="float32")
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(dataclasses.replace(
        get_config("llava15-7b").reduced(), dtype="float32"))
    return rmodel, jax.tree.map(np.asarray, rparams), tmodel


def run_both(llava32, policy: str, steps: int = 1, **kw):
    """``steps`` steps of the reference's jitted step and of the port's on
    the same parameters and batch -> (ref state, ref metrics, port state,
    port metrics, the port's parameters before the first step)."""
    rmodel, np_params, tmodel = llava32
    tpol, rpol = POLICIES[policy]
    rcfg = RO.OptimizerConfig(name="adamw")
    batch = make_batch(rmodel)
    rparams = jax.tree.map(jnp.asarray, np_params)
    mask = RTS.PM.trainable_mask(rmodel.spec, rpol)
    trainable, _ = RTS.PM.partition_params(rparams, mask)
    rstate = RTS.TrainState(params=rparams,
                            opt=RO.init_opt_state(trainable, rcfg),
                            step=jnp.zeros((), jnp.int32))
    rstep = jax.jit(RTS.make_train_step(rmodel, rpol, rcfg, **kw))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    tparams = tmodel.from_numpy(np_params, "cpu")
    before = {n: p.detach().clone() for n, p in tparams.named_parameters()}
    tstate = train_state(tparams, tpol, OptimizerConfig(name="adamw"))
    tstep = make_train_step(tmodel, tpol, OptimizerConfig(name="adamw"),
                            **kw)
    tb = {k: to_torch(v) for k, v in batch.items()}
    for _ in range(steps):
        rstate, rmetrics = rstep(rstate, jb)
        tstate, tmetrics = tstep(tstate, tb)
    return rstate, rmetrics, tstate, tmetrics, before


def check_step(rstate, rmetrics, tstate, tmetrics, before, policy: str,
               norm_rtol: float = 1e-5):
    tpol = POLICIES[policy][0]
    assert set(tmetrics) == {"loss", "xent", "grad_norm"}
    for key in tmetrics:
        np.testing.assert_allclose(
            float(tmetrics[key]), float(rmetrics[key]),
            rtol=norm_rtol if key == "grad_norm" else 1e-5, err_msg=key)
    assert int(tstate.step) == int(rstate.step)
    moved = frozen = 0
    for name, p in tstate.params.named_parameters():
        got = p.detach()
        if not tpol.is_trainable(TPM.module_path(name)):
            assert not p.requires_grad, name
            assert torch.equal(got, before[name]), f"frozen {name} moved"
            frozen += 1
            continue
        assert p.requires_grad, name
        assert not torch.equal(got, before[name]), f"{name} did not move"
        moved += 1
        want = ref_leaf(rstate.params, name)
        tol = 2 ** -8 if p.dtype == torch.bfloat16 else 1e-4
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol * scale, err_msg=name)
    assert moved and (frozen or policy == "full")


@pytest.mark.parametrize("policy", list(POLICIES))
def test_one_step_matches_the_reference(policy, llava32):
    check_step(*run_both(llava32, policy), policy)


def test_grad_accum_matches_the_reference(llava32):
    rstate, rmetrics, tstate, tmetrics, before = run_both(
        llava32, "llava_stage2", grad_accum=2)
    check_step(rstate, rmetrics, tstate, tmetrics, before, "llava_stage2")


def test_compressed_grads_match_the_reference(llava32):
    check_step(*run_both(llava32, "llava_stage1", compress_grads=True),
               "llava_stage1", norm_rtol=1e-3)


def test_two_steps_and_remat_dots_match_the_reference(llava32):
    check_step(*run_both(llava32, "full", steps=2, remat="dots"), "full")


def test_grad_accum_is_the_full_batch_step(llava32):
    """grad_accum=2 over two equal halves is the full-batch step: same
    loss, nearly the same update (the port's own two paths)."""
    rmodel, np_params, tmodel = llava32
    batch = {k: to_torch(v) for k, v in make_batch(rmodel, seed=5).items()}
    out = []
    for accum in (1, 2):
        st = train_state(tmodel.from_numpy(np_params, "cpu"), LLAVA_STAGE2,
                         OptimizerConfig(name="adamw"))
        st, m = make_train_step(tmodel, LLAVA_STAGE2,
                                OptimizerConfig(name="adamw"),
                                grad_accum=accum)(st, batch)
        out.append((st, m))
    np.testing.assert_allclose(float(out[0][1]["loss"]),
                               float(out[1][1]["loss"]), rtol=1e-5)
    p1 = dict(out[0][0].params.named_parameters())
    for name, p in out[1][0].params.named_parameters():
        assert float((p - p1[name]).detach().abs().max()) < 5e-2, name


def test_loss_decreases_under_training():
    """smollm-360m reduced in bf16, one fixed batch, 30 steps of AdamW at
    lr 1e-3 (the reference's tests/test_models.py criterion)."""
    model = build_model(get_config("smollm-360m").reduced())
    state = init_train_state(model, FULL_TRAIN,
                             OptimizerConfig(name="adamw", lr=1e-3),
                             torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, model.cfg.vocab, (4, 64))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    step = make_train_step(model, FULL_TRAIN,
                           OptimizerConfig(name="adamw", lr=1e-3))
    losses = []
    for _ in range(30):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.7, losses[::6]
    assert int(state.step) == 30


def test_step_refuses_what_one_device_cannot_do(llava32):
    _, _, tmodel = llava32
    cfg = OptimizerConfig(name="adamw")
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(tmodel, FULL_TRAIN, cfg, grad_accum=0)
    rmodel, np_params, _ = llava32
    st = train_state(tmodel.from_numpy(np_params, "cpu"), LLAVA_STAGE1, cfg)
    batch = {k: to_torch(v) for k, v in make_batch(rmodel,
                                                   batch=3).items()}
    # ZeRO shardings need the parameters placed on a mesh (one device
    # holds plain tensors)
    with pytest.raises(ValueError, match="not placed on a mesh"):
        make_train_step(tmodel, FULL_TRAIN, cfg, zero_shardings={})(st,
                                                                   batch)
    with pytest.raises(ValueError, match="equal microbatches"):
        make_train_step(tmodel, LLAVA_STAGE1, cfg, grad_accum=2)(st, batch)


def test_train_state_marks_the_policy(llava32):
    """Stage 1 trains the projector alone; the optimizer state covers
    exactly the trainable leaves."""
    rmodel, np_params, tmodel = llava32
    st = train_state(tmodel.from_numpy(np_params, "cpu"), LLAVA_STAGE1,
                     OptimizerConfig(name="adamw"))
    names = [n for n, _ in TPM.trainable_params(st.params)]
    assert names and all(".projector." in n for n in names)
    assert set(st.opt) == set(names)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    mask = RTS.PM.trainable_mask(rmodel.spec, RSPEC.LLAVA_STAGE1)
    flat = jax.tree_util.tree_flatten_with_path(mask)[0]
    want = {"/".join(k.key for k in path[:-2]) for path, m in flat if m}
    assert {TPM.module_path(n) for n in names} == want
