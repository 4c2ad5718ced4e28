"""Port of the MoE FFN (``repro_torch.models.moe``) and of the runnable MoE
family (arctic-480b through ``models.transformer``) against the reference
package, on the CPU; and the mesh shape context (``mesh_ctx``) that picks
the MoE path.

Inputs are made with numpy from a seed; the reference's parameters are
carried across (``Model.from_numpy``: the stacked (L, E, D, F) expert
leaves bit for bit).  The reference runs eagerly (``jax.disable_jit``),
op for op (C6), in bf16; the fp32 model tests read its jitted program
(fp32 rounds alike in both, as in tests/test_torch_train.py).  Its
expert-parallel path runs under a 1 x 1
``mesh_context`` (``launch.mesh.make_smoke_mesh``), the port's under
``mesh_context({"data": 1, "model": 1})``.

Tolerances:

* routing (fp32): probabilities and renormalized weights within 1e-6,
  expert indices equal; capacities and slots equal as integers;
* the MoE FFN and its pieces in fp32: within 1e-5 of the output's scale
  (max |ref|); in bf16 within 2e-2 of it;
* the reduced arctic in fp32: loss within 1e-5 relative, each gradient
  leaf within 1e-4 of its scale; in bf16 the loss within 2e-2 and each
  leaf within the larger of 2e-2 and 1.5x the reference's own
  jitted-vs-eager spread of that leaf (C8), a spread held under 5e-2;
* prefill and teacher-forced decode in bf16: logits within 2e-2 of their
  scale (max(1, max |ref|)), as the serving tests;
* one Adafactor step (fp32): every leaf within 1e-4 of its scale, the
  state bytes of every leaf equal to ``opt_bytes_for``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import spec as RSPEC
from repro.launch.mesh import make_smoke_mesh
from repro.mesh_ctx import mesh_context as ref_mesh_context
from repro.models import build_model as ref_build
from repro.models import moe as RMOE
from repro.train import optimizer as RO
from repro.train import train_step as RTS
from repro_torch import mesh_ctx as TMC
from repro_torch.configs import get_config
from repro_torch.core import factors as TF
from repro_torch.core.parser import parse_model
from repro_torch.core.spec import FULL_TRAIN
from repro_torch.models import build_model
from repro_torch.models import moe as TMOE
from repro_torch.models import param as TPM
from repro_torch.models import transformer as TT
from repro_torch.train import OptimizerConfig, make_train_step, train_state
from repro_torch.train import optimizer as TO
from tests.test_torch_train import leaf_close, ref_leaf, to_torch

ARCH = "arctic-480b"
MESH = {"data": 1, "model": 1}
SPREAD_CAP = 5e-2
B, SEQ = 2, 24


def rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def layer(E=4, D=16, F=8, shared=0, seed=0, dtype=np.float32):
    """One MoE layer's parameters as numpy (router fp32, experts in
    ``dtype``), the reference's shapes."""
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(dtype)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32),
         "wg": w(E, D, F), "wu": w(E, D, F), "wd": w(E, F, D)}
    if shared:
        p.update(shared_wg=w(D, F * shared), shared_wu=w(D, F * shared),
                 shared_wd=w(F * shared, D))
    return p


def port_layer(p: dict):
    return TPM.LayerParams({k: to_torch(np.asarray(v)) for k, v in p.items()})


def meta_of(p: dict, top_k=2, cf=1.25, shared=0) -> dict:
    E, D, F = p["wg"].shape
    return {"n_experts": E, "top_k": top_k, "d_expert": F, "d_model": D,
            "capacity_factor": cf, "n_shared_experts": shared}


def tokens(T=24, D=16, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((T, D)).astype(dtype)


# ---------------------------------------------------------------------------
# routing helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_route_matches_the_reference(top_k):
    logits = np.random.default_rng(top_k).standard_normal((40, 8)) \
        .astype(np.float32) * 3
    wp, wi, wprobs = RMOE._route(jnp.asarray(logits), top_k)
    tp, ti, tprobs = TMOE._route(torch.tensor(logits), top_k)
    assert ti.shape == (40, top_k) and tp.dtype == torch.float32
    assert np.array_equal(ti.numpy(), np.asarray(wi))
    np.testing.assert_allclose(tp.numpy(), np.asarray(wp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(wprobs), rtol=0,
                               atol=1e-6)


def test_route_breaks_ties_by_the_lower_index():
    """Equal probabilities: the lower expert index first, as ``lax.top_k``
    orders them (``torch.topk`` does not promise an order)."""
    logits = np.array([[1.0, 3.0, 3.0, 0.0, 3.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.0, 5.0, 1.0, 5.0, 5.0]], np.float32)
    _, wi, _ = RMOE._route(jnp.asarray(logits), 2)
    _, ti, _ = TMOE._route(torch.tensor(logits), 2)
    assert ti.tolist() == [[1, 2], [0, 1], [1, 3]] == np.asarray(wi).tolist()


@pytest.mark.parametrize("t,k,e,cf", [(24, 2, 4, 1.25), (4096, 2, 128, 1.25),
                                      (16, 2, 128, 1.25), (1000, 6, 64, 1.0),
                                      (24, 2, 4, 0.25), (333, 1, 7, 2.0)])
def test_capacity_matches_the_reference(t, k, e, cf):
    assert TMOE._capacity(t, k, e, cf) == RMOE._capacity(t, k, e, cf)
    assert TMOE._capacity(t, k, e, cf) % 8 == 0


def test_load_balance_loss_matches_the_reference():
    logits = np.random.default_rng(3).standard_normal((50, 6)) \
        .astype(np.float32)
    _, wi, wprobs = RMOE._route(jnp.asarray(logits), 2)
    _, ti, tprobs = TMOE._route(torch.tensor(logits), 2)
    want = RMOE.load_balance_loss(wprobs, wi, 6)
    got = TMOE.load_balance_loss(tprobs, ti, 6)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_expert_ffn_matches_the_reference(dtype):
    p = layer(dtype=dtype)
    xb = np.random.default_rng(5).standard_normal((4, 8, 16)).astype(dtype)
    want = RMOE._expert_ffn(*(jnp.asarray(p[k]) for k in ("wg", "wu", "wd")),
                            jnp.asarray(xb))
    got = TMOE._expert_ffn(*(to_torch(np.asarray(p[k]))
                             for k in ("wg", "wu", "wd")),
                           to_torch(np.asarray(xb)))
    assert rel(got, np.asarray(want, np.float32)) <= \
        (1e-5 if dtype == np.float32 else 2e-2)


def test_slots_are_unique_and_in_token_order():
    """The kept (expert, slot) pairs are unique, so the dispatch is a plain
    write (no accumulate); slots count the earlier pairs of each expert."""
    rng = np.random.default_rng(6)
    flat_e = torch.tensor(rng.integers(0, 5, 200))
    slot = TMOE._slots(flat_e, 5)
    for e in range(5):
        assert slot[flat_e == e].tolist() == list(range(int(
            (flat_e == e).sum())))
    C = 24
    keep = slot < C
    pairs = set(zip(flat_e[keep].tolist(), slot[keep].tolist()))
    assert len(pairs) == int(keep.sum())


# ---------------------------------------------------------------------------
# the two paths
# ---------------------------------------------------------------------------


def ref_ep(p, x, top_k, cf):
    E = p["wg"].shape[0]
    with jax.disable_jit():
        return RMOE._ep_local(jnp.asarray(x), *(jnp.asarray(p[k]) for k in
                                                ("router", "wg", "wu", "wd")),
                              top_k=top_k, n_experts=E, cf=cf,
                              ep_axis="model", ep_size=1)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_ep_local_matches_the_reference(cf, dtype):
    """cf 0.25 forces drops (capacity 8 for 48 pairs over 4 experts): a
    dropped pair contributes zeros on both sides."""
    p = layer(dtype=dtype)
    x = tokens(dtype=dtype).reshape(2, 12, 16)
    want = ref_ep(p, x, 2, cf)
    got, top_i, _ = TMOE._ep_local(to_torch(np.asarray(x)),
                                   *(to_torch(np.asarray(p[k])) for k in
                                     ("router", "wg", "wu", "wd")),
                                   top_k=2, n_experts=4, cf=cf, ep_size=1)
    assert got.dtype == to_torch(np.asarray(x)).dtype
    assert tuple(got.shape) == x.shape
    assert rel(got, np.asarray(want, np.float32)) <= \
        (1e-5 if dtype == np.float32 else 2e-2)
    dropped = int((TMOE._slots(top_i.reshape(-1), 4)
                   >= TMOE._capacity(24, 2, 4, cf)).sum())
    assert (dropped > 0) == (cf < 1)


def test_ep_local_refuses_an_expert_parallel_axis():
    """Without ranks (a mesh shape, no DeviceMesh) an expert-parallel axis
    is refused, naming the DeviceMesh form that runs it."""
    p = {k: torch.tensor(v) for k, v in layer().items()}
    with pytest.raises(NotImplementedError, match="DeviceMesh"):
        TMOE._ep_local(torch.zeros(2, 4, 16), p["router"], p["wg"], p["wu"],
                       p["wd"], top_k=2, n_experts=4, cf=1.25, ep_size=2)
    with TMC.mesh_context({"data": 1, "model": 2}):
        with pytest.raises(NotImplementedError, match="DeviceMesh"):
            TMOE.moe_forward(port_layer(layer()), torch.zeros(2, 4, 16),
                             meta_of(layer()))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_dense_moe_matches_the_reference(dtype):
    p = layer(dtype=dtype)
    x = tokens(dtype=dtype)
    with jax.disable_jit():
        wy, waux = RMOE._dense_moe(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), meta_of(p))
    ty, taux = TMOE._dense_moe(port_layer(p), to_torch(np.asarray(x)),
                               meta_of(p))
    assert rel(ty, np.asarray(wy, np.float32)) <= \
        (1e-5 if dtype == np.float32 else 2e-2)
    np.testing.assert_allclose(float(taux), float(waux), rtol=1e-6)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("mesh", [False, True])
def test_moe_forward_matches_the_reference(mesh, shared):
    """With and without a mesh (the expert-parallel and the dense path),
    with a shared expert (deepseek's, tested here at function level: its
    model needs MLA, ROADMAP A7b)."""
    p = layer(shared=shared)
    meta = meta_of(p, shared=shared)
    x = tokens(seed=8).reshape(2, 12, 16)
    with jax.disable_jit():
        if mesh:
            with ref_mesh_context(make_smoke_mesh()):
                wy, waux = RMOE.moe_forward(jax.tree.map(jnp.asarray, p),
                                            jnp.asarray(x), meta)
        else:
            wy, waux = RMOE.moe_forward(jax.tree.map(jnp.asarray, p),
                                        jnp.asarray(x), meta)
    if mesh:
        with TMC.mesh_context(MESH):
            ty, taux = TMOE.moe_forward(port_layer(p), torch.tensor(x), meta)
    else:
        ty, taux = TMOE.moe_forward(port_layer(p), torch.tensor(x), meta)
    assert rel(ty, wy) <= 1e-5
    np.testing.assert_allclose(float(taux), float(waux), rtol=1e-6)


def test_moe_forward_runs_each_data_shard_with_its_own_capacity():
    """A data axis of 2: each half of the batch is dispatched alone (the
    reference's per-device shards), the aux loss over all tokens."""
    p = layer(seed=9)
    x = torch.tensor(tokens(T=48, seed=10).reshape(4, 12, 16))
    lp = port_layer(p)
    meta = meta_of(p, cf=0.5)
    with TMC.mesh_context({"data": 2, "model": 1}):
        y, aux = TMOE.moe_forward(lp, x, meta)
    args = (lp.router, lp.wg, lp.wu, lp.wd)
    halves = [TMOE._ep_local(h, *args, top_k=2, n_experts=4, cf=0.5,
                             ep_size=1)[0] for h in x.chunk(2)]
    assert torch.equal(y, torch.cat(halves))
    _, top_i, probs = TMOE._route(x.reshape(48, 16) @ lp.router, 2)
    assert torch.allclose(aux, TMOE.load_balance_loss(probs, top_i, 4),
                          rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the mesh shape context
# ---------------------------------------------------------------------------


def test_mesh_context_nests_and_restores():
    assert TMC.current_mesh_shape() is None and TMC.mesh_axis_sizes() == {}
    with TMC.mesh_context(MESH, {"seq": ("model",)}):
        assert TMC.current_mesh_shape() == MESH
        assert TMC.mesh_axis_sizes() == MESH
        assert TMC.current_rules()["seq"] == ("model",)
        with TMC.mesh_context(None):
            assert TMC.current_mesh_shape() is None
            assert TMC.current_rules()["seq"] == ()
        assert TMC.current_mesh_shape() == MESH
    assert TMC.current_mesh_shape() is None
    assert TMC.current_rules() == TMC.DEFAULT_RULES
    assert TMC.mesh_axis_sizes({"data": 4}) == {"data": 4}


# ---------------------------------------------------------------------------
# the reduced arctic: loss and gradients, serving, an Adafactor step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pairs(reduced_zoo):
    """dtype -> (ref model, ref params, port model, port params)."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            if dtype == "bfloat16":
                _, rmodel, rparams = reduced_zoo(ARCH)
            else:
                rmodel = ref_build(dataclasses.replace(
                    ref_config(ARCH).reduced(), dtype=dtype))
                rparams = rmodel.init(jax.random.PRNGKey(0))
            tmodel = build_model(dataclasses.replace(
                get_config(ARCH).reduced(), dtype=dtype))
            tparams = tmodel.from_numpy(jax.tree.map(np.asarray, rparams),
                                        "cpu")
            cache[dtype] = (rmodel, rparams, tmodel, tparams)
        return cache[dtype]
    return get


def batch_of(seed: int, b: int = B, s: int = SEQ):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32),
            "labels": rng.integers(0, 256, (b, s)).astype(np.int32)}


_REF = {}


def ref_value_and_grad(rmodel, rparams, batch, mesh: bool, jit=False):
    """The reference's loss and gradients (remat does not change them), one
    run per model, batch, mesh and program."""
    key = (id(rparams), batch["tokens"].tobytes(), mesh, jit)
    if key not in _REF:
        vg = jax.value_and_grad(rmodel.loss, has_aux=True)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with ref_mesh_context(make_smoke_mesh() if mesh else None):
            if jit:
                _REF[key] = jax.jit(vg)(rparams, jb)
            else:
                with jax.disable_jit():
                    _REF[key] = vg(rparams, jb)
    return _REF[key]


def port_loss_and_grads(tmodel, tparams, batch, mesh: bool, remat=None):
    TPM.set_trainable(tparams, FULL_TRAIN)
    named = TPM.trainable_params(tparams)
    with TMC.mesh_context(MESH if mesh else None):
        loss, metrics = tmodel.loss(tparams, {k: to_torch(v) for k, v in
                                              batch.items()}, remat=remat)
    # the backward runs outside the context: the recompute takes the
    # forward's path all the same
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss, metrics, dict(zip([n for n, _ in named], grads))


def test_from_numpy_carries_the_stacked_expert_leaves(pairs):
    rmodel, rparams, tmodel, tparams = pairs("bfloat16")
    blocks = tparams.language_model.blocks
    stacked = np.asarray(rparams["language_model"]["blocks"]["ffn"]["wg"])
    assert stacked.shape == (2, 4, 64, 32)
    for i, bp in enumerate(blocks):
        assert bp.ffn.wg.dtype == torch.bfloat16
        assert np.array_equal(bp.ffn.wg.float().numpy(),
                              stacked[i].astype(np.float32))
        assert bp.ffn.router.dtype == torch.float32
    for name, p in tparams.named_parameters():
        assert np.array_equal(p.detach().float().numpy(),
                              ref_leaf(rparams, name)), name


@pytest.mark.parametrize("remat", ["block", "none", "dots"])
@pytest.mark.parametrize("mesh", [True, False])
def test_loss_and_grads_match_the_reference_fp32(mesh, remat, pairs):
    rmodel, rparams, tmodel, tparams = pairs("float32")
    batch = batch_of(1)
    (want, metrics), grads = ref_value_and_grad(rmodel, rparams, batch, mesh,
                                                jit=True)
    loss, tmetrics, tgrads = port_loss_and_grads(tmodel, tparams, batch,
                                                 mesh, remat)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for key in ("xent", "aux"):
        np.testing.assert_allclose(float(tmetrics[key]),
                                   float(metrics[key]), rtol=1e-5,
                                   err_msg=key)
    assert float(tmetrics["aux"]) > 0
    for name, g in tgrads.items():
        leaf_close(g, ref_leaf(grads, name), 1e-4, f"d{name}")


def test_mesh_and_meshless_paths_differ_only_by_the_capacity(pairs):
    """Without drops (cf large enough) the two paths agree; the reduced
    config at cf 1.25 drops some pairs, so its meshless loss is the dense
    path's, not the dispatched one's."""
    _, _, tmodel, tparams = pairs("float32")
    batch = batch_of(2)
    lm, _, _ = port_loss_and_grads(tmodel, tparams, batch, True)
    ld, _, _ = port_loss_and_grads(tmodel, tparams, batch, False)
    cfg = dataclasses.replace(tmodel.cfg, moe=dataclasses.replace(
        tmodel.cfg.moe, capacity_factor=4.0))
    wide = build_model(cfg)
    lw, _, _ = port_loss_and_grads(wide, tparams, batch, True)
    np.testing.assert_allclose(float(lw.detach()), float(ld.detach()),
                               rtol=1e-5)
    assert float(lm.detach()) != float(ld.detach())


@pytest.mark.parametrize("mesh", [True, False])
def test_loss_and_grads_match_the_eager_reference_bf16(mesh, pairs):
    rmodel, rparams, tmodel, tparams = pairs("bfloat16")
    batch = batch_of(4)
    (want, _), grads = ref_value_and_grad(rmodel, rparams, batch, mesh)
    (_, _), jit_grads = ref_value_and_grad(rmodel, rparams, batch, mesh,
                                           jit=True)
    loss, _, tgrads = port_loss_and_grads(tmodel, tparams, batch, mesh)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=2e-2)
    for name, g in tgrads.items():
        want_g = ref_leaf(grads, name)
        spread = rel(ref_leaf(jit_grads, name), want_g)
        assert spread <= SPREAD_CAP, (name, spread)
        leaf_close(g, want_g, max(2e-2, 1.5 * spread),
                   f"d{name} (reference jit-vs-eager spread {spread:.3g})")


def logits_close(got, want, what):
    want = np.asarray(want, np.float32)
    tol = 2e-2 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("mesh", [True, False])
def test_prefill_and_teacher_forced_decode_match_the_reference(mesh, pairs):
    """bf16: the prefill's logits and cache, then decode steps fed the same
    tokens, each step's logits against the reference's (4 steps under the
    mesh, whose eager reference is slow; 8 without)."""
    rmodel, rparams, tmodel, tparams = pairs("bfloat16")
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 256, (B, 16)).astype(np.int32)
    n_steps = 4 if mesh else 8
    feed = rng.integers(0, 256, (B, n_steps)).astype(np.int32)
    rctx = lambda: ref_mesh_context(make_smoke_mesh() if mesh else None)
    with rctx(), jax.disable_jit():
        want, wcache = rmodel.prefill(rparams,
                                      {"tokens": jnp.asarray(prompt)})
    with TMC.mesh_context(MESH if mesh else None), torch.inference_mode():
        got, cache = tmodel.prefill(tparams, {"tokens": torch.tensor(prompt)})
    logits_close(got, want, "prefill")
    for key in ("k", "v"):
        assert cache["blocks"][key].dtype == torch.bfloat16
        logits_close(cache["blocks"][key],
                     np.asarray(wcache["blocks"][key], np.float32), key)
    from repro.serve import pad_cache as ref_pad
    from repro_torch.serve import pad_cache
    wcache, cache = ref_pad(wcache, n_steps), pad_cache(cache, n_steps)
    for t in range(n_steps):
        tok = feed[:, t:t + 1]
        with rctx(), jax.disable_jit():
            want, wcache = rmodel.decode_step(rparams, jnp.asarray(tok),
                                              wcache)
        with TMC.mesh_context(MESH if mesh else None), \
                torch.inference_mode():
            got, cache = tmodel.decode_step(tparams, torch.tensor(tok), cache)
        logits_close(got, want, f"decode {t}")
    assert cache["len"].tolist() == [16 + n_steps] * B


def test_init_cache_has_one_stack_per_block_kind():
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    cfg = dataclasses.replace(cfg, mla=None, n_heads=4, n_kv_heads=2)
    cache = build_model(cfg).init_cache(3, 10, "cpu")
    assert tuple(cache["dense_blocks"]["k"].shape) == (1, 3, 10, 2, 16)
    assert tuple(cache["blocks"]["k"].shape) == (cfg.n_layers - 1, 3, 10, 2,
                                                 16)
    arctic = build_model(get_config(ARCH).reduced()).init_cache(2, 5, "cpu")
    assert set(arctic) == {"blocks", "len"}


def test_leading_dense_blocks_and_shared_experts_run_as_the_reference():
    """An MoE config with a leading dense block and a shared expert (as
    deepseek's, on GQA attention here: MLA waits for ROADMAP A7b), fp32,
    under the mesh: loss and gradients."""
    def cfg_of(get):
        c = get("deepseek-v2-lite-16b").reduced()
        return dataclasses.replace(c, mla=None, n_heads=4, n_kv_heads=2,
                                   dtype="float32")
    rmodel = ref_build(cfg_of(ref_config))
    rparams = rmodel.init(jax.random.PRNGKey(1))
    tmodel = build_model(cfg_of(get_config))
    tparams = tmodel.from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    assert "dense_blocks" in tparams.language_model
    batch = batch_of(12)
    (want, _), grads = ref_value_and_grad(rmodel, rparams, batch, True,
                                          jit=True)
    loss, _, tgrads = port_loss_and_grads(tmodel, tparams, batch, True)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for name, g in tgrads.items():
        leaf_close(g, ref_leaf(grads, name), 1e-4, f"d{name}")


def test_one_adafactor_step_on_the_stacked_expert_leaves(pairs):
    """arctic's own optimizer, fp32, under the mesh: the step against the
    reference's jitted step leaf by leaf, and each leaf's state bytes
    equal to the byte model's ``opt_bytes_for`` of its stacked shape (the
    (L, E, D, F) expert stacks factored per layer and expert)."""
    rmodel, rparams, tmodel, _ = pairs("float32")
    np_params = jax.tree.map(np.asarray, rparams)
    batch = batch_of(7)
    rcfg = RO.OptimizerConfig(name="adafactor")
    mask = RTS.PM.trainable_mask(rmodel.spec, RSPEC.FULL_TRAIN)
    trainable, _ = RTS.PM.partition_params(rparams, mask)
    rstate = RTS.TrainState(params=rparams,
                            opt=RO.init_opt_state(trainable, rcfg),
                            step=jnp.zeros((), jnp.int32))
    with ref_mesh_context(make_smoke_mesh()):
        rstate, rmetrics = jax.jit(RTS.make_train_step(
            rmodel, RSPEC.FULL_TRAIN, rcfg))(
            rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    opt = OptimizerConfig(name="adafactor")
    tstate = train_state(tmodel.from_numpy(np_params, "cpu"), FULL_TRAIN,
                         opt)
    want_bytes = {}
    for r in parse_model(tmodel.spec, FULL_TRAIN):
        for pname, p in r.layer.params.items():
            shape, _ = TF._stacked(p, r)
            want_bytes[f"{r.module_path.replace('/', '.')}.{r.layer.name}."
                       f"{pname}"] = TF.opt_bytes_for(p, shape, "adafactor") \
                * (1 if r.scanned else r.repeat)
    assert TO.state_bytes(tstate.opt) == want_bytes
    wg = tstate.opt["language_model.blocks.ffn.wg"]
    assert tuple(wg["v_row"].shape) == (2, 4, 64)
    assert tuple(wg["v_col"].shape) == (2, 4, 32)
    with TMC.mesh_context(MESH):
        tstate, tmetrics = make_train_step(tmodel, FULL_TRAIN, opt)(
            tstate, {k: to_torch(v) for k, v in batch.items()})
    for key in ("loss", "xent", "grad_norm"):
        np.testing.assert_allclose(float(tmetrics[key]),
                                   float(rmetrics[key]), rtol=1e-5,
                                   err_msg=key)
    for name, p in tstate.params.named_parameters():
        leaf_close(p, ref_leaf(rstate.params, name), 1e-4, name)


def test_dense_models_make_no_aux_tensor(pairs):
    """A dense model's backbone returns the float 0.0 for its aux (no
    tensor is allocated) and its loss reports no aux."""
    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    hidden, aux = TT.lm_backbone(cfg, params.language_model,
                                 TT.embed_tokens(cfg, params.language_model,
                                                 toks))
    assert aux == 0.0 and not isinstance(aux, torch.Tensor)
    _, metrics = model.loss(params, {"tokens": toks, "labels": toks})
    assert set(metrics) == {"xent", "n_tok"}


def test_large_leaves_are_scaled_in_place_to_the_same_values(monkeypatch):
    """A leaf of ``IN_PLACE_ELEMENTS`` or more (an arctic-480b expert
    stack) is scaled in place at init, so its transient is one fp32 draw:
    the values are those of the out-of-place program, bit for bit."""
    full = get_config(ARCH)
    threshold = TPM.IN_PLACE_ELEMENTS
    assert full.moe.n_experts * full.d_model * full.moe.d_expert >= threshold
    # the largest leaf of the measured grid's archs keeps the old program
    seamless = get_config("seamless-m4t-large-v2")
    assert seamless.vocab * seamless.d_model < threshold
    model = build_model(get_config(ARCH).reduced())
    want = model.init(torch.Generator().manual_seed(3), "cpu")
    monkeypatch.setattr(TPM, "IN_PLACE_ELEMENTS", 0)
    got = model.init(torch.Generator().manual_seed(3), "cpu")
    for (name, a), (_, b) in zip(want.named_parameters(),
                                 got.named_parameters()):
        assert torch.equal(a, b), name
