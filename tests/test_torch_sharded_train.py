"""The port's ZeRO train step and re-sharding restore across processes.

Four gloo ranks (separate processes over a ``FileStore`` in ``tmp_path``)
form the (2, 2) ``data, model`` mesh of ``launch.mesh.make_smoke_mesh``.
A reduced model, on the reference's weights carried across, is placed
with ``param_shardings`` / ``opt_shardings`` / ``batch_shardings`` and
stepped with ``zero_shardings``; every rank gathers the whole state after
the step.

* The reduced smollm-360m in bf16: the AdamW step's loss, gradient norm,
  m, v, fp32 master and bf16 parameters against the port's one-device
  step at the bounds of ``check_adamw_step`` (bf16 roundings of the
  gradients, a few fp32 steps of the update), and its loss against the
  reference's jitted step within the reference's bound for its own
  sharded step (``tests/test_system.py``: 1e-3); one step each of
  Adafactor and 8-bit Adam (whose state is updated on the whole leaf)
  against the port's one-device step of each.  Then every rank restores
  a checkpoint with ``shardings``: each leaf comes back a ``DTensor`` on
  its placements whose local shard is the block the reference's spec
  gives the rank (blocks ordered major to minor by the spec's axes), and
  whose whole is the saved value bit for bit.
* The reduced deepseek-v2-lite-16b in fp32 (its MoE through the
  expert-parallel exchange and the aux loss over every rank's routing):
  loss, gradient norm and every leaf's m and v at 1e-5 against the
  one-device step, and every leaf's m at 1e-5 against the reference's.

Every rank sets a 60 s process-group timeout and destroys its group; the
ranks run under a subprocess timeout.
"""

import dataclasses
import json
import os
import subprocess
import sys
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.core.spec import FULL_TRAIN as REF_FULL_TRAIN
from repro.models import build_model as ref_build
from repro.models import param as RPM
from repro.train import OptimizerConfig as RefOpt
from repro.train import TrainState as RefState
from repro.train import make_train_step as ref_step
from repro.train.optimizer import init_opt_state
from repro_torch import checkpoint as TC
from repro_torch.configs import get_config
from repro_torch.core.spec import FULL_TRAIN
from repro_torch.models import build_model
from repro_torch.train import OptimizerConfig, make_train_step, train_state

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANKS = 4
RANK_TIMEOUT_S = 240


def spawn_ranks(code: str, tmp_path, n: int = RANKS,
                env: Optional[dict] = None) -> list:
    """Run ``code`` in ``n`` processes (env ``RANK``, ``WORLD``, ``STORE``,
    ``OUT`` and ``env``), each under a timeout; every rank must exit 0.
    Returns each rank's stdout."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               WORLD=str(n), STORE=str(tmp_path / "store"),
               OUT=str(tmp_path), OMP_NUM_THREADS="1", **(env or {}))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    outs, failed = [], []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            outs.append(out)
            if p.returncode != 0:
                failed.append(f"rank {r} exit {p.returncode}:\n{out}\n{err}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failed, "\n".join(failed)
    return outs


def flat_np(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_np(v, prefix + (k,)))
        return out
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":        # npz keeps no bfloat16: the bits
        return {"/".join(prefix) + "::bf16": a.view(np.uint16)}
    return {"/".join(prefix): a}


RANK_PRELUDE = r'''
import json, os
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
out_dir = os.environ["OUT"]
dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=60))
torch.manual_seed(0)
'''

SHARDED_STEP = RANK_PRELUDE + r'''
ARCH, FULL = os.environ["ARCH"], os.environ.get("FULL") == "1"
OTHERS = [dict(name="adafactor", master_fp32=False), dict(name="adamw8bit")]
try:
    import dataclasses

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.spec import FULL_TRAIN
    from repro_torch.launch import mesh as M
    from repro_torch.mesh_ctx import mesh_context
    from repro_torch.models import build_model, param as PM
    from repro_torch.train import (OptimizerConfig, make_train_step,
                                   train_state)
    from torch.distributed.tensor import DTensor

    import ml_dtypes

    def unflat(npz):
        tree = {}
        for key in npz.files:
            node = tree
            name, _, bf16 = key.partition("::")
            *path, last = name.split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[last] = npz[key].view(ml_dtypes.bfloat16) if bf16 \
                else npz[key]
        return tree

    def whole(t):
        t = t.detach()
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t if t.dtype == torch.int8 else t.float()

    def dump(state, metrics, tag):
        # every rank gathers (a collective); rank 0 writes
        out = {"p/" + n: whole(t).numpy()
               for n, t in state.params.named_parameters()}
        out.update({f"o/{leaf}/{k}": whole(t).numpy()
                    for leaf, st in state.opt.items()
                    for k, t in st.items()})
        if rank == 0:
            np.savez(os.path.join(out_dir, f"sharded_{tag}.npz"),
                     loss=float(metrics["loss"]),
                     grad_norm=float(metrics["grad_norm"]),
                     step=int(state.step), **out)

    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              dtype=os.environ["DTYPE"])
    if cfg.moe:     # no drops: the expert-parallel path is the dense one
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    model = build_model(cfg)
    weights = unflat(np.load(os.path.join(out_dir, "weights.npz")))
    batch_np = dict(np.load(os.path.join(out_dir, "batch.npz")))
    opt_cfg = OptimizerConfig()
    shape = ShapeConfig("t", 32, 4, "train")
    mesh = M.make_smoke_mesh(2, 2, device_type="cpu")
    with mesh_context(mesh, M.arch_rules(cfg)):
        psh = M.param_shardings(model, mesh)
        mask = PM.trainable_mask(model.spec, FULL_TRAIN)
        t_specs, _ = PM.partition_params(model.param_specs(), mask)
        t_axes, _ = PM.partition_params(model.param_axes(), mask)
        osh = M.opt_shardings(model, mesh, t_specs, opt_cfg, t_axes)
        zsh = M.zero_grad_shardings(mesh, t_specs, t_axes)
        bsh = M.batch_shardings(mesh, model.batch_spec(shape))
        state = M.place_train_state(
            train_state(model.from_numpy(weights, "cpu"), FULL_TRAIN,
                        opt_cfg), psh, osh)
        batch = {k: bsh[k].place(torch.from_numpy(v))
                 for k, v in batch_np.items()}
        assert batch["tokens"].to_local().shape == (2, 32)
        step = make_train_step(model, FULL_TRAIN, opt_cfg,
                               zero_shardings=zsh)
        state, metrics = step(state, batch)
        dump(state, metrics, "adamw")
        # the other optimizers' one step from the same weights: Adafactor's
        # factored moments and 8-bit Adam's flat blocks update on the
        # whole leaf
        for kw in OTHERS if FULL else ():
            ocfg = OptimizerConfig(**kw)
            t_osh = M.opt_shardings(model, mesh, t_specs, ocfg, t_axes)
            ost = M.place_train_state(
                train_state(model.from_numpy(weights, "cpu"), FULL_TRAIN,
                            ocfg), psh, t_osh)
            ost, om = make_train_step(model, FULL_TRAIN, ocfg,
                                      zero_shardings=zsh)(ost, batch)
            dump(ost, om, kw["name"])
    strided = sorted({str(p) for st in state.opt.values()
                      for t in st.values()
                      for p in t.placements if "_S(" in str(p)})
    if rank == 0:
        with open(os.path.join(out_dir, "sharded.json"), "w") as f:
            json.dump({"strided": strided}, f)
    if not FULL:
        print("RESTORED", 0)
        raise SystemExit(0)

    # the restore: the one-device checkpoint onto the mesh
    like = M.place_train_state(
        train_state(model.from_numpy(weights, "cpu"), FULL_TRAIN, opt_cfg),
        psh, osh)
    step_n, got = Checkpointer(os.path.join(out_dir, "ckpt")).restore_latest(
        like, M.train_state_shardings(like, psh, osh))
    want = train_state(model.from_numpy(weights, "cpu"), FULL_TRAIN,
                       opt_cfg)
    coords = mesh.get_coordinate()
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))

    def expected_local(full, spec):
        """The block of ``full`` the reference's spec gives this rank:
        on each dim, block index = sum of coordinates major to minor."""
        idx = []
        for d, entry in enumerate(spec):
            axes = () if entry is None else \
                (entry,) if isinstance(entry, str) else entry
            n_blocks, block = 1, 0
            for a in axes:
                i = mesh.mesh_dim_names.index(a)
                block = block * sizes[a] + coords[i]
                n_blocks *= sizes[a]
            size = full.shape[d] // n_blocks
            idx.append(slice(block * size, (block + 1) * size))
        return full[tuple(idx)]

    checked = 0
    for name, t in got.params.named_parameters():
        sh = PM.sharding_of(psh, name)
        full = dict(want.params.named_parameters())[name].detach()
        assert isinstance(t, DTensor), name
        assert t.placements == sh.placements, (name, t.placements)
        assert tuple(t.to_local().shape) == sh.local_shape(full.shape), name
        assert torch.equal(t.to_local(), expected_local(full, sh.spec)), name
        assert torch.equal(t.full_tensor(), full), name
        checked += 1
    for leaf, st in got.opt.items():
        for k, t in st.items():
            sh = PM.sharding_of(osh, leaf)[k]
            full = want.opt[leaf][k]
            assert isinstance(t, DTensor) and t.placements == sh.placements
            assert torch.equal(t.to_local(), expected_local(full, sh.spec))
            assert torch.equal(t.full_tensor(), full), (leaf, k)
            checked += 1
    assert step_n == 0 and int(got.step) == 0
    print("RESTORED", checked)
finally:
    dist.destroy_process_group()
'''


def case_config(cfg, dtype: str):
    """A reduced config in ``dtype`` whose MoE drops no (token, expert)
    pair (capacity factor 8): the expert-parallel path then computes the
    one-device dense path's function."""
    cfg = dataclasses.replace(cfg, dtype=dtype)
    if not cfg.moe:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


def reference_step(arch: str, dtype: str):
    """The reduced ``arch``'s weights, a batch, and the reference's jitted
    one-device AdamW step on them: (weights, batch, loss, grad_norm, the
    updated params and optimizer state, flat by the port's names)."""
    cfg = case_config(ref_config(arch).reduced(), dtype)
    model = ref_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    mask = RPM.trainable_mask(model.spec, REF_FULL_TRAIN)
    tr, _ = RPM.partition_params(params, mask)
    state = RefState(params=params, opt=init_opt_state(tr, RefOpt()),
                     step=jnp.int32(0))
    s1, m1 = jax.jit(ref_step(model, REF_FULL_TRAIN, RefOpt()))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    flat = {k.removesuffix("::bf16").replace("/", "."): v
            for k, v in flat_np(jax.tree.map(
                lambda a: np.asarray(a, np.float32), s1.opt)).items()}
    return (jax.tree.map(np.asarray, params), batch, float(m1["loss"]),
            float(m1["grad_norm"]), flat)


def one_device(arch: str, dtype: str, weights, batch, opt_cfg) -> tuple:
    """The port's one-device step of ``opt_cfg`` on the reference's
    weights -> (whole initial state, whole state after, metrics), numpy
    by the keys the ranks write."""
    model = build_model(case_config(get_config(arch).reduced(), dtype))
    st = train_state(model.from_numpy(weights, "cpu"), FULL_TRAIN, opt_cfg)

    def flat(st):
        out = {"p/" + n: t.detach().float().numpy().copy()
               for n, t in st.params.named_parameters()}
        out.update({f"o/{leaf}/{k}": (t if t.dtype == torch.int8
                                      else t.float()).numpy().copy()
                    for leaf, s in st.opt.items() for k, t in s.items()})
        return out

    init = flat(st)
    st, metrics = make_train_step(model, FULL_TRAIN, opt_cfg)(
        st, {k: torch.from_numpy(v) for k, v in batch.items()})
    return init, flat(st), {k: float(v) for k, v in metrics.items()}


def leaf_err(got, want) -> float:
    """The worst difference over the leaf's scale."""
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 at |x| (its 8-bit significand)."""
    return np.ldexp(1.0, np.frexp(np.abs(x).astype(np.float32))[1] - 8)


def write_inputs(arch: str, dtype: str, tmp_path) -> tuple:
    weights, batch, *rest = reference_step(arch, dtype)
    np.savez(tmp_path / "weights.npz", **flat_np(weights))
    np.savez(tmp_path / "batch.npz", **batch)
    return (weights, batch, *rest)


def run_zero_step(arch: str, dtype: str, tmp_path, full: bool) -> dict:
    """The ranks' ZeRO step of ``arch`` (``full``: also Adafactor, 8-bit
    Adam and the restore) -> their whole state after it, by optimizer."""
    outs = spawn_ranks(SHARDED_STEP, tmp_path,
                       env={"ARCH": arch, "DTYPE": dtype,
                            "FULL": "1" if full else "0"})
    assert all("RESTORED" in o for o in outs)
    return {name: dict(np.load(tmp_path / f"sharded_{name}.npz"))
            for name in (("adamw", "adafactor", "adamw8bit") if full
                         else ("adamw",))}


def adam_direction(st: dict, leaf: str, cfg) -> np.ndarray:
    """m_hat / (sqrt(v_hat) + eps) of a leaf's state after step 1: the
    direction its master moved in (times lr)."""
    m = st[f"o/{leaf}/m"].astype(np.float64) / (1 - cfg.b1)
    v = st[f"o/{leaf}/v"].astype(np.float64) / (1 - cfg.b2)
    return m / (np.sqrt(v) + cfg.eps)


def check_adamw_step(got: dict, init: dict, one: dict, fp32_leaves: set,
                     cfg) -> None:
    """The ranks' AdamW step (``got``) against the one-device step
    (``one``) from the same state (``init``).

    The gradients are in the leaf's type.  A bf16 one is rounded on each
    rank before the average over ``data``, where the one-device step
    rounds the whole batch's once, so m (0.1 g) is held to 2^-6 and v
    (0.05 g^2) to 2^-5 of the leaf's scale (4 bf16 steps at its largest
    element); an fp32 leaf (the MoE router) to 1e-5.  The fp32 master
    moves by -lr * (u + wd * w), where u = m_hat / (sqrt(v_hat) + eps)
    is about the sign of g: the two masters differ by lr times the
    difference of the two u, within 4 fp32 steps of the master and of lr
    (a sign that a rounding flips moves its element by 2 lr).  The bf16 parameters are the master
    rounded: within one bf16 step plus that, and they moved from the
    initial weights."""
    assert float(got["step"]) == 1
    moved, changed = [], []
    for k, want in one.items():
        if not k.startswith("o/"):
            continue
        leaf, part = k[2:].rsplit("/", 1)
        g = got[k].astype(np.float64)
        if part in ("m", "v"):
            tol = 1e-5 if leaf in fp32_leaves else \
                2.0 ** (-6 if part == "m" else -5)
            assert leaf_err(g, want) <= tol, (k, leaf_err(g, want))
            continue
        du = adam_direction(got, leaf, cfg) - adam_direction(one, leaf, cfg)
        off = np.abs(g - want + cfg.lr * du) - 4 * (
            np.spacing(np.abs(want)) + np.spacing(np.float32(cfg.lr)))
        assert (off <= 0).all(), (k, float(off.max()))
        moved.append((np.abs(g - init[k]) > cfg.lr / 2).reshape(-1))
    # every parameter with a gradient moved by about lr
    assert np.concatenate(moved).mean() > 0.9
    for k, want in one.items():
        if not k.startswith("p/"):
            continue
        names = k[2:].split(".")
        leaf = ".".join(n for n in names if not n.isdigit())
        layer = tuple(int(n) for n in names if n.isdigit())
        du = (adam_direction(got, leaf, cfg)
              - adam_direction(one, leaf, cfg))[layer]
        off = np.abs(got[k] - want) - bf16_ulp(want) - cfg.lr * np.abs(du)
        assert (off <= 1e-9).all(), (k, float(off.max()))
        changed.append((got[k] != init[k]).reshape(-1))
    assert np.concatenate(changed).mean() > 0.5


def fp32_leaves(arch: str, dtype: str) -> set:
    """The port's optimizer leaves whose parameters are fp32."""
    model = build_model(case_config(get_config(arch).reduced(), dtype))
    return {".".join(k for k in n.split(".") if not k.isdigit())
            for n, t in model.init(torch.Generator().manual_seed(0),
                                   "cpu").named_parameters()
            if t.dtype == torch.float32}


def test_zero_step_on_a_2x2_mesh_matches_one_device(tmp_path):
    """The reduced smollm-360m in its own bf16: the AdamW step against the
    port's one-device step (``check_adamw_step``) and the reference's
    jitted one (loss within its bound for its sharded step,
    ``tests/test_system.py``); Adafactor and 8-bit Adam against the
    port's one-device step of each; then the restore (the ranks' own
    checks)."""
    arch, dtype = "smollm-360m", "bfloat16"
    weights, batch, ref_loss, ref_gn, _ = write_inputs(arch, dtype, tmp_path)
    model = build_model(get_config(arch).reduced())
    st = train_state(model.from_numpy(weights, "cpu"), FULL_TRAIN,
                     OptimizerConfig())
    TC.save_checkpoint(str(tmp_path / "ckpt"), 0, st)
    got = run_zero_step(arch, dtype, tmp_path, full=True)
    info = json.loads((tmp_path / "sharded.json").read_text())
    # the zero-extra `data` axis lands after `model` on some dims: the
    # strided placement the module's note describes is exercised
    assert info["strided"], info
    init, one, m_one = one_device(arch, dtype, weights, batch,
                                  OptimizerConfig())
    adamw = got["adamw"]
    # the loss is the mean of the ranks' equal shares; the gradient's norm
    # is of bf16 gradients rounded apart (1e-3 of it)
    assert abs(float(adamw["loss"]) - m_one["loss"]) < 1e-5
    assert abs(float(adamw["grad_norm"]) / m_one["grad_norm"] - 1) < 1e-3
    assert abs(float(adamw["loss"]) - ref_loss) < 1e-3
    assert abs(float(adamw["grad_norm"]) / ref_gn - 1) < 1e-2
    check_adamw_step(adamw, init, one, fp32_leaves(arch, dtype),
                     OptimizerConfig())
    # Adafactor and 8-bit Adam, whose state updates on the whole leaf:
    # the state (8-bit Adam's blocks dequantized) at the bf16 bound of
    # v, and the parameters within one bf16 step plus lr (a step moves an
    # element by about lr; a flipped sign of g, by 2 lr at most)
    for kw in (dict(name="adafactor", master_fp32=False),
               dict(name="adamw8bit")):
        cfg = OptimizerConfig(**kw)
        init, one, m_one = one_device(arch, dtype, weights, batch, cfg)
        g = got[kw["name"]]
        assert abs(float(g["loss"]) - m_one["loss"]) < 1e-5, kw
        assert abs(float(g["grad_norm"]) / m_one["grad_norm"] - 1) < 1e-3
        for k, want in one.items():
            if k.endswith(("/v_row", "/v_col", "/v")):
                assert leaf_err(g[k], want) <= 2.0 ** -5, (kw, k)
            elif k.endswith(("/m_q", "/v_q")):
                s = k[:-2] + "_s"
                err = leaf_err(g[k] * g[s][:, None],
                               want * one[s][:, None])
                assert err <= 2.0 ** -5, (kw, k, err)
            elif k.startswith(("p/", "o/")) and k.endswith(
                    ("/master",)) or k.startswith("p/"):
                off = np.abs(g[k] - want) - bf16_ulp(want) - 2 * cfg.lr
                assert (off <= 0).all(), (kw, k, float(off.max()))
        changed = np.concatenate([(g[k] != init[k]).reshape(-1)
                                  for k in one if k.startswith("p/")])
        assert changed.mean() > 0.3, (kw, changed.mean())


def test_zero_step_of_an_moe_model_on_a_2x2_mesh(tmp_path):
    """The reduced deepseek-v2-lite-16b (MLA, one dense block, one MoE
    block of 4 experts, top 2, a shared expert; no drops) in fp32 through
    the ZeRO step: the expert-parallel path runs the all-to-all over
    ``model`` and the aux loss over every rank's routing.  Its loss,
    gradient norm and every leaf's AdamW state (m and v at 1e-5 of each
    leaf's scale: the router's includes the aux loss's gradient) against
    the one-device step's, and its loss, norm and every leaf's first
    moment (0.1 times the gradient) against the reference's jitted
    one-device step, at 1e-5 of each."""
    arch, dtype = "deepseek-v2-lite-16b", "float32"
    weights, batch, ref_loss, ref_gn, ref_opt = write_inputs(arch, dtype,
                                                             tmp_path)
    got = run_zero_step(arch, dtype, tmp_path, full=False)["adamw"]
    init, one, m_one = one_device(arch, dtype, weights, batch,
                                  OptimizerConfig())
    assert abs(float(got["loss"]) / m_one["loss"] - 1) < 1e-5
    assert abs(float(got["grad_norm"]) / m_one["grad_norm"] - 1) < 1e-5
    assert abs(float(got["loss"]) / ref_loss - 1) < 1e-5
    assert abs(float(got["grad_norm"]) / ref_gn - 1) < 1e-5
    check_adamw_step(got, init, one, fp32_leaves(arch, dtype),
                     OptimizerConfig())
    leaves = [k[:-len(".m")] for k in ref_opt if k.endswith(".m")]
    assert "language_model.blocks.ffn.router" in leaves
    for leaf in leaves:
        err = leaf_err(got[f"o/{leaf}/m"], ref_opt[f"{leaf}.m"])
        assert err <= 1e-5, (leaf, err)
