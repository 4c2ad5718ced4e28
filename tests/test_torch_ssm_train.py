"""Port of the pure-SSM training path (``repro_torch.models.mamba``:
``_segsum``, ``ssd_chunked``, ``mamba2_forward``; ``ssm_lm``:
``ssm_backbone``, ``ssm_loss``; ``Model.loss`` and ``make_train_step``
for mamba2) against the reference package, on the CPU.

The reduced mamba2-1.3b (2 layers, d_model 64, 8 heads x 16, d_state 16,
chunk 32) with the reference's parameters carried across by
``Model.from_numpy``; inputs made with numpy from a seed.  The reference
runs eagerly (``jax.disable_jit``), op for op (C6), except where a test
says it reads the reference's jitted program too.

Tolerances:

* ``ssd_chunked`` in fp32: y and the final state within 2e-5 of their
  scale (max |ref|) against the reference's ``ssd_chunked`` and its
  sequential ``ssd_reference``; every input's gradient within 1e-4 of its
  scale;
* the reduced model in fp32: the loss within 1e-5 relative, each
  gradient leaf within 1e-4 of its scale, under remat none / block /
  dots; ``mamba2_forward`` within 2e-5 of scale;
* in bf16 (C8's rule): the loss within 2e-2; each gradient leaf within
  the larger of 2e-2 of its scale and 1.5x that leaf's own
  jitted-vs-eager spread in the reference, a spread held under 5e-2;
* one AdamW train step: metrics within 1e-5 relative, every updated leaf
  within 1e-4 of its scale.
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
from repro.models import mamba as RM
from repro.train import optimizer as RO
from repro.train import train_step as RTS
from repro_torch.configs import get_config
from repro_torch.core.spec import FULL_TRAIN
from repro_torch.models import build_model
from repro_torch.models import mamba as TM
from repro_torch.models import param as TPM
from repro_torch.models import ssm_lm as TSL
from repro_torch.train import OptimizerConfig, make_train_step, train_state
from tests.test_torch_train import leaf_close, ref_leaf, to_torch

ARCH = "mamba2-1.3b"
B, SEQ = 2, 40                 # one chunk of 32 and a ragged rest of 8
SPREAD_CAP = 5e-2


def rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def ssd_inputs(seed: int, b=2, S=40, H=3, P=4, N=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((b, S, 1, N)).astype(np.float32)
    Cm = rng.standard_normal((b, S, 1, N)).astype(np.float32)
    s0 = rng.standard_normal((b, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("n", [1, 5, 16])
def test_segsum_matches_the_reference(n):
    a = -np.abs(np.random.default_rng(n).standard_normal((3, n))) \
        .astype(np.float32)
    got = TM._segsum(torch.tensor(a)).numpy()
    want = np.asarray(RM._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    # the two cumsums add in another order: 1e-6 of the scale
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want[fin]).max()))
    assert np.isneginf(got[..., 0, 1:]).all() if n > 1 else True


# (S, chunk, initial state): ragged and exact last chunks, a prompt
# shorter than one chunk, with and without a carried-in state
SSD_CASES = [(40, 16, True), (40, 16, False), (32, 16, True),
             (7, 16, True), (40, 40, False)]


@pytest.mark.parametrize("S,chunk,init", SSD_CASES)
def test_ssd_chunked_matches_the_reference_fp32(S, chunk, init):
    x, dt, A, Bm, Cm, s0 = ssd_inputs(S, S=S)
    s0 = s0 if init else None
    with jax.disable_jit():
        yr, fr = RM.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
                                None if s0 is None else jnp.asarray(s0))
    ys, fs = RM.ssd_reference(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                              None if s0 is None else jnp.asarray(s0))
    yt, ft = TM.ssd_chunked(*map(torch.tensor, (x, dt, A, Bm, Cm)), chunk,
                            None if s0 is None else torch.tensor(s0))
    assert yt.dtype == torch.float32 and ft.dtype == torch.float32
    assert tuple(yt.shape) == x.shape and tuple(ft.shape) == (2, 3, 4, 5)
    for got, want in ((yt, yr), (ft, fr), (yt, ys), (ft, fs)):
        assert rel(got, want) <= 2e-5


@pytest.mark.parametrize("S,chunk,init", SSD_CASES)
def test_ssd_chunked_gradients_match_the_reference(S, chunk, init):
    """Every input's gradient (x, dt, A, B, C and the carried-in state)
    of a random projection of y and the final state."""
    x, dt, A, Bm, Cm, s0 = ssd_inputs(100 + S, S=S)
    rng = np.random.default_rng(S)
    wy = rng.standard_normal(x.shape).astype(np.float32)
    ws = rng.standard_normal(s0.shape).astype(np.float32)
    args = [x, dt, A, Bm, Cm] + ([s0] if init else [])

    def f(*a):
        y, st = RM.ssd_chunked(*a[:5], chunk, a[5] if init else None)
        return (y * wy).sum() + (st * ws).sum()
    with jax.disable_jit():
        want = jax.grad(f, argnums=tuple(range(len(args))))(
            *map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y, st = TM.ssd_chunked(*ts[:5], chunk, ts[5] if init else None)
    got = torch.autograd.grad((y * torch.tensor(wy)).sum()
                              + (st * torch.tensor(ws)).sum(), ts)
    for g, w, name in zip(got, want, "x dt A B C s0".split()):
        assert rel(g, w) <= 1e-4, name


def test_ssd_chunked_casts_y_per_chunk_and_carries_fp32():
    """bf16 x: y comes back bf16 (each chunk cast, as the reference's
    body), the state fp32, both within bf16 rounding of the reference."""
    x, dt, A, Bm, Cm, s0 = ssd_inputs(3)
    xb = torch.tensor(x).to(torch.bfloat16)
    yt, ft = TM.ssd_chunked(xb, torch.tensor(dt), torch.tensor(A),
                            torch.tensor(Bm), torch.tensor(Cm), 16)
    assert yt.dtype == torch.bfloat16 and ft.dtype == torch.float32
    with jax.disable_jit():
        yr, fr = RM.ssd_chunked(jnp.asarray(x, jnp.bfloat16),
                                *map(jnp.asarray, (dt, A, Bm, Cm)), 16)
    assert rel(yt, np.asarray(yr, np.float32)) <= 2e-2
    assert rel(ft, fr) <= 1e-4


def test_ssd_chunked_saves_no_decay_matrix():
    """What the backward keeps of the SSD is each chunk's inputs and the
    fp32 state carried into it (the byte model's ``chunk_states``): no
    (b, H, Q, Q) tensor is saved for the backward, because each chunk's
    body reruns there (the reference's ``jax.checkpoint`` in its scan)."""
    b, S, H, P, N, Q = 2, 64, 3, 4, 5, 16
    x, dt, A, Bm, Cm, _ = ssd_inputs(4, b=b, S=S, H=H, P=P, N=N)
    ts = [torch.tensor(a, requires_grad=True) for a in (x, dt, A, Bm, Cm)]
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, st = TM.ssd_chunked(*ts, Q)
    assert (b, H, Q, Q) not in shapes
    states = [s for s in shapes if s == (b, H, P, N)]
    assert len(states) == S // Q          # the state into each chunk
    torch.autograd.grad(y.sum() + st.sum(), ts)


@pytest.fixture(scope="module")
def fp32_pair():
    """(ref model, ref params, port model, port params), reduced, fp32."""
    rcfg = dataclasses.replace(ref_config(ARCH).reduced(), dtype="float32")
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(dataclasses.replace(get_config(ARCH).reduced(),
                                             dtype="float32"))
    tparams = tmodel.from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    return rmodel, rparams, tmodel, tparams


@pytest.fixture(scope="module")
def bf16_pair(reduced_zoo):
    cfg, rmodel, rparams = reduced_zoo(ARCH)
    tmodel = build_model(get_config(ARCH).reduced())
    tparams = tmodel.from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    return rmodel, rparams, tmodel, tparams


def batch_of(seed: int, vocab: int = 256, b: int = B, s: int = SEQ):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def test_from_numpy_carries_the_fp32_ssm_leaves_bit_for_bit(bf16_pair):
    rmodel, rparams, tmodel, tparams = bf16_pair
    for name, p in tparams.named_parameters():
        want = np.asarray(ref_leaf(rparams, name))
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("A_log", "D", "dt_bias"):
            assert p.dtype == torch.float32
        assert np.array_equal(p.detach().float().numpy(), want), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_matches_the_reference(dtype, fp32_pair, bf16_pair):
    rmodel, rparams, tmodel, tparams = \
        fp32_pair if dtype == "float32" else bf16_pair
    meta = TSL._meta(tmodel.cfg)
    rng = np.random.default_rng(7)
    h = (rng.standard_normal((B, SEQ, tmodel.cfg.d_model)) * 0.5) \
        .astype(np.float32)
    with jax.disable_jit():
        want = RM.mamba2_forward(
            jax.tree.map(lambda a: a[0],
                         rparams["language_model"]["blocks"]["mixer"]),
            jnp.asarray(h, dtype), meta)
    got = TM.mamba2_forward(tparams.language_model.blocks[0].mixer,
                            to_torch(np.asarray(jnp.asarray(h, dtype))), meta)
    assert got.dtype == TPM.TORCH_DTYPES[dtype]
    assert rel(got, np.asarray(want, np.float32)) <= \
        (2e-5 if dtype == "float32" else 2e-2)


def port_loss_and_grads(tmodel, tparams, batch, remat=None):
    TPM.set_trainable(tparams, FULL_TRAIN)
    named = TPM.trainable_params(tparams)
    loss, metrics = tmodel.loss(tparams, {k: to_torch(v)
                                          for k, v in batch.items()},
                                remat=remat)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss, metrics, dict(zip([n for n, _ in named], grads))


@pytest.mark.parametrize("remat", ["none", "block", "dots"])
def test_ssm_loss_and_grads_match_the_reference_fp32(remat, fp32_pair):
    rmodel, rparams, tmodel, tparams = fp32_pair
    batch = batch_of(1)
    vg = jax.value_and_grad(
        lambda p, b: rmodel.loss(p, b, remat=remat), has_aux=True)
    with jax.disable_jit():
        (want, metrics), grads = vg(rparams, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
    loss, tmetrics, tgrads = port_loss_and_grads(tmodel, tparams, batch,
                                                 remat)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics["xent"]),
                               float(metrics["xent"]), rtol=1e-5)
    assert float(tmetrics["n_tok"]) == float(metrics["n_tok"]) == B * SEQ
    assert len(tgrads) == len(list(tparams.parameters()))
    for name, g in tgrads.items():
        p = dict(tparams.named_parameters())[name]
        assert g.dtype == p.dtype and g.shape == p.shape, name
        leaf_close(g, ref_leaf(grads, name), 1e-4, f"d{name} ({remat})")


def test_remat_policies_give_the_same_loss_and_grads(fp32_pair):
    """none / block / dots recompute the same ops: loss and every gradient
    bit-equal across the policies."""
    rmodel, rparams, tmodel, tparams = fp32_pair
    batch = batch_of(2)
    runs = {r: port_loss_and_grads(tmodel, tparams, batch, r)
            for r in ("none", "block", "dots")}
    loss0, _, grads0 = runs["none"]
    for remat in ("block", "dots"):
        loss, _, grads = runs[remat]
        assert torch.equal(loss, loss0), remat
        for name in grads0:
            assert torch.equal(grads[name], grads0[name]), (remat, name)


def test_ssm_loss_and_grads_match_the_eager_reference_bf16(bf16_pair):
    rmodel, rparams, tmodel, tparams = bf16_pair
    batch = batch_of(4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vg = jax.value_and_grad(rmodel.loss, has_aux=True)
    with jax.disable_jit():
        (want, _), grads = vg(rparams, jb)
    (_, _), jit_grads = jax.jit(vg)(rparams, jb)
    loss, _, tgrads = port_loss_and_grads(tmodel, tparams, batch)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=2e-2)
    for name, g in tgrads.items():
        want_g = ref_leaf(grads, name)
        spread = rel(ref_leaf(jit_grads, name), want_g)
        assert spread <= SPREAD_CAP, (name, spread)
        leaf_close(g, want_g, max(2e-2, 1.5 * spread),
                   f"d{name} (reference jit-vs-eager spread {spread:.3g})")


def test_remat_block_reruns_each_block_in_the_backward(fp32_pair,
                                                      monkeypatch):
    """Under "block" each Mamba-2 block runs twice per step (the
    recompute), under "none" once."""
    rmodel, rparams, tmodel, tparams = fp32_pair
    calls = []
    fwd = TSL.mamba2_forward
    monkeypatch.setattr(TSL, "mamba2_forward",
                        lambda *a, **k: calls.append(1) or fwd(*a, **k))
    for remat, want in (("none", 1), ("block", 2)):
        calls.clear()
        port_loss_and_grads(tmodel, tparams, batch_of(5), remat)
        assert len(calls) == want * tmodel.cfg.n_layers, remat


def test_model_loss_of_the_full_config_routes_to_ssm_loss(monkeypatch):
    """``build_model(get_config("mamba2-1.3b")).loss`` runs ``ssm_loss``
    (no parameter is made: the call is intercepted)."""
    model = build_model(get_config(ARCH))
    seen = []
    monkeypatch.setattr(TSL, "ssm_loss",
                        lambda cfg, p, b, remat=None: seen.append(
                            (cfg.name, remat)) or (0.0, {}))
    model.loss(None, {}, remat="dots")
    assert seen == [(ARCH, "dots")]


def test_one_adamw_step_matches_the_reference(fp32_pair):
    """One AdamW ``make_train_step`` step under FULL_TRAIN against the
    reference's jitted step: metrics and every leaf."""
    rmodel, rparams, tmodel, _ = fp32_pair
    np_params = jax.tree.map(np.asarray, rparams)
    batch = batch_of(6)
    rcfg = RO.OptimizerConfig(name="adamw")
    mask = RTS.PM.trainable_mask(rmodel.spec, RSPEC.FULL_TRAIN)
    trainable, _ = RTS.PM.partition_params(rparams, mask)
    rstate = RTS.TrainState(params=rparams,
                            opt=RO.init_opt_state(trainable, rcfg),
                            step=jnp.zeros((), jnp.int32))
    rstate, rmetrics = jax.jit(RTS.make_train_step(
        rmodel, RSPEC.FULL_TRAIN, rcfg))(
        rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = tmodel.from_numpy(np_params, "cpu")
    before = {n: p.detach().clone() for n, p in tparams.named_parameters()}
    tstate = train_state(tparams, FULL_TRAIN, OptimizerConfig(name="adamw"))
    tstate, tmetrics = make_train_step(
        tmodel, FULL_TRAIN, OptimizerConfig(name="adamw"))(
        tstate, {k: to_torch(v) for k, v in batch.items()})
    for key in ("loss", "xent", "grad_norm"):
        np.testing.assert_allclose(float(tmetrics[key]),
                                   float(rmetrics[key]), rtol=1e-5,
                                   err_msg=key)
    assert int(tstate.step) == 1
    for name, p in tstate.params.named_parameters():
        assert not torch.equal(p.detach(), before[name]), name
        leaf_close(p, ref_leaf(rstate.params, name), 1e-4, name)
