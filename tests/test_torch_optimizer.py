"""Port of the optimizers (repro_torch.train.optimizer) against the
reference's ``repro.train.optimizer.apply_updates`` on the same numpy
leaves and gradients, three successive steps, params and every state
tensor compared.

The port's tensors are per layer where the reference stacks the layers on
a leading axis; the port groups them back into the reference's leaves
(``param.Leaf``) and is compared with the reference's own update of the
whole leaf: per layer for a stacked leaf of 3 or more dims under AdamW
and Adafactor (the reference's chunked update), whole for a stack of
vectors under Adafactor (one factored second moment over the layers) and
for every leaf under 8-bit Adam (256-value blocks that straddle layers).

Tolerance: 1e-6 relative (and 1e-6 of the tensor's largest magnitude
absolute) on fp32 params and states — the same fp32 formulas, summed in
another order only in Adafactor's means.  int8 states exactly, except for
at most one step of the grid on a value that sits on a rounding boundary
(``round(x / scale)`` of an fp32 that the two sides computed one ulp
apart); the count of such values is bounded too.  State bytes equal the
byte model's ``opt_bytes_for`` exactly, and AdamW is bit-equal to the
per-tensor update it ran before the leaves were grouped.
"""

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
from repro_torch.core import factors as TF
from repro_torch.core.parser import parse_model
from repro_torch.core.spec import LLAVA_STAGE2
from repro_torch.models import build_model
from repro_torch.models import param as TPM
from repro_torch.train import optimizer as TO
from repro_torch.train import train_state

# name -> (shape, stacked?) — stacked leaves carry a leading layers axis
LEAVES = {
    "w": ((64, 48), False),
    "b": ((48,), False),
    "blocks_w": ((3, 32, 40), True),      # 1,280 = 5 x 256 per layer
    "blocks_s": ((3, 40), True),          # a stack of vectors
    "blocks_odd": ((3, 10, 30), True),    # 300 per layer: 8-bit blocks
                                          # straddle layers
    "one_s": ((1, 40), True),             # a stack of one layer
}
CONFIGS = {
    "adamw": TO.OptimizerConfig(name="adamw", lr=1e-2),
    "adamw_no_master": TO.OptimizerConfig(name="adamw", lr=1e-2,
                                          master_fp32=False),
    "adamw8bit": TO.OptimizerConfig(name="adamw8bit", lr=1e-2),
    "adafactor": TO.OptimizerConfig(name="adafactor", lr=1e-2),
}


def ref_cfg(cfg: TO.OptimizerConfig) -> RO.OptimizerConfig:
    return RO.OptimizerConfig(**cfg.__dict__)


def port_leaf(name: str, a: np.ndarray) -> TPM.Leaf:
    """The port's per-layer tensors of a reference leaf, as one Leaf."""
    if LEAVES[name][1]:
        return TPM.Leaf(name, tuple((f"{name}.{i}", torch.from_numpy(
            np.array(a[i]))) for i in range(a.shape[0])), True)
    return TPM.Leaf(name, ((name, torch.from_numpy(np.array(a))),), False)


def port_grads(leaf: TPM.Leaf, g: np.ndarray) -> dict:
    return {n: torch.from_numpy(np.array(g[i] if leaf.stacked else g))
            for i, (n, _) in enumerate(leaf.params)}


def stacked(leaf: TPM.Leaf) -> np.ndarray:
    ts = [t.numpy() for _, t in leaf.params]
    return np.stack(ts) if leaf.stacked else ts[0]


def check(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype == np.int8:
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 0.01, (what, d.max())
        return
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale,
                               err_msg=what)


@pytest.mark.parametrize("leaf_name", list(LEAVES))
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_three_steps_match_the_reference(cfg_name, leaf_name):
    """The reference's whole-leaf ``apply_updates`` (its chunked route
    where it takes one) against the port's update of the grouped leaf."""
    cfg = CONFIGS[cfg_name]
    rcfg = ref_cfg(cfg)
    shape = LEAVES[leaf_name][0]
    rng = np.random.default_rng(17)
    a = rng.standard_normal(shape, np.float32)
    r_tree = {leaf_name: jnp.asarray(a)}
    r_state = RO.init_opt_state(r_tree, rcfg)
    leaf = port_leaf(leaf_name, a)
    t_state = TO.init_opt_state([leaf], cfg)
    assert set(t_state) == set(r_state)
    assert set(t_state[leaf_name]) == set(r_state[leaf_name])

    for step in range(1, 4):
        g = rng.standard_normal(shape, np.float32) * (0.1 * step)
        r_tree, r_state = RO.apply_updates(
            r_tree, {leaf_name: jnp.asarray(g)}, r_state, jnp.float32(step),
            rcfg)
        TO.apply_updates([leaf], port_grads(leaf, g), t_state,
                         torch.tensor(float(step)), cfg)
        what = f"{cfg_name} step {step} {leaf_name}"
        check(stacked(leaf), r_tree[leaf_name], what)
        for key, val in t_state[leaf_name].items():
            check(val.numpy(), r_state[leaf_name][key], f"{what} {key}")


def test_factored_stack_of_vectors_has_one_state():
    """Adafactor on a (layers, width) stack: ``v_row (L,)`` + ``v_col
    (d,)``, as the reference holds it, and one RMS clip over the stack."""
    a = np.ones((3, 40), np.float32)
    leaf = port_leaf("blocks_s", a)
    st = TO.init_opt_state([leaf], CONFIGS["adafactor"])["blocks_s"]
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {"v_row": (3,), "v_col": (40,)}
    assert TO.state_bytes({"blocks_s": st})["blocks_s"] == \
        TF.opt_bytes_for(None, (3, 40), "adafactor") == 4 * (3 + 40)


def parent_adamw(p, g, st: dict, step, cfg: TO.OptimizerConfig) -> None:
    """The per-tensor AdamW update the port ran before its tensors were
    grouped into the reference's leaves, kept as the yardstick."""
    g = g.to(torch.float32)
    master = st.get("master")
    x = master if master is not None else p.to(torch.float32)
    m = cfg.b1 * st["m"] + (1 - cfg.b1) * g
    v = cfg.b2 * st["v"] + (1 - cfg.b2) * g * g
    mhat = m / (1 - cfg.b1 ** step)
    vhat = v / (1 - cfg.b2 ** step)
    upd = mhat / (torch.sqrt(vhat) + cfg.eps)
    st["m"].copy_(m)
    st["v"].copy_(v)
    x = x - cfg.lr * (upd + cfg.weight_decay * x)
    if master is not None:
        master.copy_(x)
    p.copy_(x)


@pytest.mark.parametrize("master_fp32", [True, False])
def test_adamw_step_is_bit_equal_to_the_per_tensor_update(master_fp32):
    """The reduced llava15-7b in bf16 under LLAVA stage 2: three AdamW
    steps of the grouped update against the per-tensor update on the same
    tensors and gradients, every parameter and state slice bit-equal."""
    model = build_model(get_config("llava15-7b").reduced())
    cfg = TO.OptimizerConfig(name="adamw", lr=1e-2,
                             master_fp32=master_fp32)
    params = TPM.set_trainable(
        model.init(torch.Generator().manual_seed(0), "cpu"), LLAVA_STAGE2)
    twin = {n: t.detach().clone()
            for n, t in TPM.trainable_params(params)}
    leaves = TPM.trainable_leaves(params)
    state = TO.init_opt_state(leaves, cfg)
    old = {n: {"m": torch.zeros(t.shape), "v": torch.zeros(t.shape)}
           for n, t in twin.items()}
    if master_fp32:
        for n, t in twin.items():
            old[n]["master"] = t.to(torch.float32, copy=True)
    gen = torch.Generator().manual_seed(1)
    for step in range(1, 4):
        grads = {n: torch.randn(t.shape, generator=gen).to(t.dtype)
                 for n, t in twin.items()}
        TO.apply_updates(leaves, grads, state, torch.tensor(float(step)),
                         cfg)
        for n, t in twin.items():
            parent_adamw(t, grads[n], old[n], torch.tensor(float(step)),
                         cfg)
    for leaf in leaves:
        for i, (n, p) in enumerate(leaf.params):
            assert torch.equal(p.detach(), twin[n]), n
            for key, val in state[leaf.name].items():
                got = val[i] if leaf.stacked else val
                assert torch.equal(got, old[n][key]), (n, key)


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_state_bytes_equal_the_byte_model(cfg_name):
    """The reduced llava15-7b under LLAVA stage 2 (its stacked (L, d)
    norm scales are where a per-layer state would differ): every leaf's
    state bytes equal ``opt_bytes_for`` of the leaf's stacked shape."""
    cfg = CONFIGS[cfg_name]
    model = build_model(get_config("llava15-7b").reduced())
    st = train_state(model.init(torch.Generator().manual_seed(0), "cpu"),
                     LLAVA_STAGE2, cfg)
    want = {}
    for r in parse_model(model.spec, LLAVA_STAGE2):
        if not r.trainable:
            continue
        for pname, p in r.layer.params.items():
            shape, _ = TF._stacked(p, r)
            rep = 1 if r.scanned else r.repeat
            name = f"{r.module_path.replace('/', '.')}.{r.layer.name}." \
                f"{pname}"
            want[name] = TF.opt_bytes_for(p, shape, cfg.name,
                                          cfg.master_fp32) * rep
    got = TO.state_bytes(st.opt)
    assert got == want
    norms = [n for n in got if n.endswith("norm1.scale")]
    assert norms and all(".blocks." in n for n in norms)


def test_leaves_are_the_reference_leaves():
    """``trainable_leaves`` of the reduced llava15-7b under stage 2 are the
    reference's trainable leaves: same paths, same (stacked) shapes."""
    rmodel = ref_build(ref_config("llava15-7b").reduced())
    rparams = rmodel.init(jax.random.PRNGKey(0))
    mask = RTS.PM.trainable_mask(rmodel.spec, RSPEC.LLAVA_STAGE2)
    trainable, _ = RTS.PM.partition_params(rparams, mask)
    want = {".".join(k.key for k in path): tuple(a.shape) for path, a in
            jax.tree_util.tree_flatten_with_path(trainable)[0]}
    model = build_model(get_config("llava15-7b").reduced())
    params = TPM.set_trainable(
        model.init(torch.Generator().manual_seed(0), "cpu"), LLAVA_STAGE2)
    leaves = TPM.trainable_leaves(params)
    assert {leaf.name: leaf.shape for leaf in leaves} == want
    assert any(leaf.stacked for leaf in leaves)
    # a stack is updated whole: a part of one is refused
    named = TPM.trainable_params(params)
    part = [(n, t) for n, t in named if ".blocks.1." not in n]
    with pytest.raises(ValueError, match="stacked leaf"):
        TPM.group_leaves(params, part)


def test_bf16_params_keep_the_fp32_master():
    cfg = TO.OptimizerConfig(name="adamw", lr=1e-2)
    rng = np.random.default_rng(3)
    p = rng.standard_normal((16, 24), np.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(p).view(np.int16)).view(torch.bfloat16)
    leaves = [TPM.Leaf("w", (("w", t),), False)]
    t_state = TO.init_opt_state(leaves, cfg)
    r_tree = {"w": jnp.asarray(p)}
    r_state = RO.init_opt_state(r_tree, ref_cfg(cfg))
    for step in range(1, 4):
        g = rng.standard_normal((16, 24), np.float32).astype(jnp.bfloat16)
        r_tree, r_state = RO.apply_updates(r_tree, {"w": jnp.asarray(g)},
                                           r_state, jnp.float32(step),
                                           ref_cfg(cfg))
        tg = torch.from_numpy(np.array(g).view(np.int16)) \
            .view(torch.bfloat16)
        TO.apply_updates(leaves, {"w": tg}, t_state,
                         torch.tensor(float(step)), cfg)
    check(t_state["w"]["master"].numpy(), r_state["w"]["master"], "master")
    assert t.dtype == torch.bfloat16
    # the bf16 param is the master rounded once: equal, or one bf16 ulp
    # apart where the two masters straddle a rounding boundary
    want = np.asarray(r_tree["w"], np.float32)
    np.testing.assert_allclose(t.float().numpy(), want, rtol=2 ** -8,
                               atol=0)


def test_updates_are_in_place_and_checked():
    cfg = TO.OptimizerConfig(name="adamw")
    p = torch.ones(4, 4)
    leaves = [TPM.Leaf("p", (("p", p),), False)]
    state = TO.init_opt_state(leaves, cfg)
    ptrs = (p.data_ptr(), state["p"]["master"].data_ptr(),
            state["p"]["m"].data_ptr())
    TO.apply_updates(leaves, {"p": torch.ones(4, 4)}, state,
                     torch.tensor(1.0), cfg)
    assert (p.data_ptr(), state["p"]["master"].data_ptr(),
            state["p"]["m"].data_ptr()) == ptrs
    assert not torch.equal(p, torch.ones(4, 4))
    with pytest.raises(ValueError, match="gradients"):
        TO.apply_updates(leaves, {}, state, torch.tensor(2.0), cfg)
    with pytest.raises(ValueError, match="sgd"):
        TO.init_opt_state(leaves, TO.OptimizerConfig(name="sgd"))
