"""Port of the optimizers (repro_torch.train.optimizer) against the
reference's ``repro.train.optimizer.apply_updates`` on the same numpy
leaves and gradients, three successive steps, params and every state
tensor compared.

The port's tensors are per layer where the reference stacks the layers on
a leading axis.  A stacked leaf of 3 or more dims is compared with the
reference's chunked (per-layer) update, which is the port's per-tensor
update.  Where the reference updates a stacked leaf whole — a stack of
vectors (2 dims) under Adafactor, whose second moment the reference then
factors over the layers, and every leaf under 8-bit Adam, whose 256-value
blocks then straddle layers unless a layer's size is a multiple of 256 —
the port is compared with the reference's update of each layer's slice on
its own (see the optimizer module's notes).

Tolerance: 1e-6 relative (and 1e-6 of the tensor's largest magnitude
absolute) on fp32 params and states — the same fp32 formulas, summed in
another order only in Adafactor's means.  int8 states exactly, except for
at most one step of the grid on a value that sits on a rounding boundary
(``round(x / scale)`` of an fp32 that the two sides computed one ulp
apart); the count of such values is bounded too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as RO
from repro_torch.train import optimizer as TO

# name -> (shape, stacked?) — stacked leaves carry a leading layers axis
LEAVES = {
    "w": ((64, 48), False),
    "b": ((48,), False),
    "blocks_w": ((3, 32, 40), True),      # 1,280 = 5 x 256 per layer
    "blocks_s": ((3, 40), True),          # a stack of vectors
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


def port_names(name: str) -> list:
    shape, stacked = LEAVES[name]
    return [f"{name}.{i}" for i in range(shape[0])] if stacked else [name]


def split(name: str, a: np.ndarray) -> dict:
    """The port's per-layer view of a reference leaf."""
    if LEAVES[name][1]:
        return {f"{name}.{i}": a[i] for i in range(a.shape[0])}
    return {name: a}


def whole_update(cfg_name: str, name: str) -> bool:
    """Does the reference's update of this leaf equal the port's per-layer
    updates?  (Else the port is compared slice by slice.)"""
    shape, stacked = LEAVES[name]
    if not stacked:
        return True
    if cfg_name == "adamw8bit":
        return int(np.prod(shape[1:])) % RO.BLOCK == 0
    if cfg_name == "adafactor":
        return len(shape) >= 3
    return True


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


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_three_steps_match_the_reference(cfg_name):
    cfg = CONFIGS[cfg_name]
    rcfg = ref_cfg(cfg)
    rng = np.random.default_rng(17)
    params = {n: rng.standard_normal(s, np.float32)
              for n, (s, _) in LEAVES.items()}

    # the reference: whole leaves, and every stacked leaf also slice by
    # slice (the per-layer reading the port follows)
    r_tree = {n: jnp.asarray(a) for n, a in params.items()}
    r_state = RO.init_opt_state(r_tree, rcfg)
    r_slices = {pn: jnp.asarray(a) for n, a in params.items()
                for pn, a in split(n, a).items()}
    r_slice_state = RO.init_opt_state(r_slices, rcfg)

    t_params = [(pn, torch.from_numpy(np.array(a)))
                for n, a in params.items() for pn, a in split(n, a).items()]
    t_state = TO.init_opt_state(t_params, cfg)
    assert set(t_state) == set(r_slice_state)

    for step in range(1, 4):
        grads = {n: rng.standard_normal(s, np.float32) * (0.1 * step)
                 for n, (s, _) in LEAVES.items()}
        r_tree, r_state = RO.apply_updates(
            r_tree, {n: jnp.asarray(g) for n, g in grads.items()}, r_state,
            jnp.float32(step), rcfg)
        r_slices, r_slice_state = RO.apply_updates(
            r_slices, {pn: jnp.asarray(g) for n, g in grads.items()
                       for pn, g in split(n, g).items()},
            r_slice_state, jnp.float32(step), rcfg)
        t_grads = [torch.from_numpy(np.array(g)) for n, g in grads.items()
                   for _, g in split(n, g).items()]
        TO.apply_updates(t_params, t_grads, t_state,
                         torch.tensor(float(step)), cfg)

        got = dict(t_params)
        for n in LEAVES:
            for pn in port_names(n):
                what = f"{cfg_name} step {step} {pn}"
                check(got[pn].numpy(), r_slices[pn], what)
                for key, val in t_state[pn].items():
                    check(val.numpy(), r_slice_state[pn][key],
                          f"{what} state {key}")
            if whole_update(cfg_name, n):
                want = np.asarray(r_tree[n])
                for i, pn in enumerate(port_names(n)):
                    w = want[i] if LEAVES[n][1] else want
                    check(got[pn].numpy(), w, f"{cfg_name} {pn} (whole)")
                    for key, val in t_state[pn].items():
                        ws = np.asarray(r_state[n][key])
                        if LEAVES[n][1] and key not in ("m_q", "v_q", "m_s",
                                                        "v_s"):
                            ws = ws[i]
                        elif LEAVES[n][1]:
                            per = ws.shape[0] // LEAVES[n][0][0]
                            ws = ws[i * per:(i + 1) * per]
                        check(val.numpy(), ws,
                              f"{cfg_name} {pn} state {key} (whole)")


def test_bf16_params_keep_the_fp32_master():
    cfg = TO.OptimizerConfig(name="adamw", lr=1e-2)
    rng = np.random.default_rng(3)
    p = rng.standard_normal((16, 24), np.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(p).view(np.int16)).view(torch.bfloat16)
    t_params = [("w", t)]
    t_state = TO.init_opt_state(t_params, cfg)
    r_tree = {"w": jnp.asarray(p)}
    r_state = RO.init_opt_state(r_tree, ref_cfg(cfg))
    for step in range(1, 4):
        g = rng.standard_normal((16, 24), np.float32).astype(jnp.bfloat16)
        r_tree, r_state = RO.apply_updates(r_tree, {"w": jnp.asarray(g)},
                                           r_state, jnp.float32(step),
                                           ref_cfg(cfg))
        tg = torch.from_numpy(np.array(g).view(np.int16)) \
            .view(torch.bfloat16)
        TO.apply_updates(t_params, [tg], t_state, torch.tensor(float(step)),
                         cfg)
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
    state = TO.init_opt_state([("p", p)], cfg)
    ptrs = (p.data_ptr(), state["p"]["master"].data_ptr(),
            state["p"]["m"].data_ptr())
    TO.apply_updates([("p", p)], [torch.ones(4, 4)], state,
                     torch.tensor(1.0), cfg)
    assert (p.data_ptr(), state["p"]["master"].data_ptr(),
            state["p"]["m"].data_ptr()) == ptrs
    assert not torch.equal(p, torch.ones(4, 4))
    with pytest.raises(ValueError, match="gradients"):
        TO.apply_updates([("p", p)], [], state, torch.tensor(2.0), cfg)
    with pytest.raises(ValueError, match="sgd"):
        TO.init_opt_state([("p", p)], TO.OptimizerConfig(name="sgd"))
