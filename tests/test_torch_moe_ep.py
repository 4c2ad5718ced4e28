"""The MoE's expert-parallel exchange across processes.

Four gloo ranks (separate processes over a ``FileStore`` in ``tmp_path``)
form the (2, 2) ``data, model`` mesh; each holds its rows of the tokens
(batch over ``data``, the same rows on both ranks of ``model``, as the
ZeRO step gives them) and runs ``moe.moe_forward`` under
``mesh_context(DeviceMesh)``: each rank of ``model`` takes its half of
the sequence, the all-to-all over ``model`` to the rank's two of the four
experts and back, and the halves gathered back into the rows.  On the
reduced deepseek-v2-lite-16b's MoE layer (fp32):

* at ``capacity_factor=8`` (no drops) the output is within 2e-3 of the
  port's dense path and the aux loss within 1e-3, as
  ``tests/test_system.py`` holds the reference's; the output is within
  1e-4 of the output's scale of the reference's own expert-parallel
  output on the same weights (``run_with_devices(n_devices=4)``);
* the gradients, as the ZeRO step takes them: each rank backpropagates
  ``sum(y * ct) + aux`` of its rows, and the step averages the ranks'
  gradients over ``data``.  The two ranks of ``model`` get the same
  gradients, bit for bit, and the average over ``data`` is within 1e-4
  of each gradient's scale of the dense path's gradient of the one
  scalar ``sum(y * ct) / 2 + aux`` (each rank's token gradient is twice
  its rows' share of it);
* at the default capacity factor, where pairs drop, the integer slots and
  kept mask of each rank's block of the path's own routing equal the
  reference's formula on the same block, and the output is within 1e-4
  of the scale of the reference's.
* with the expert stacks as ``DTensor``s placed on ``model`` (the rank's
  experts its local shard) the output is the same, bit for bit; under
  remat "block", whose backward reruns the layer outside the mesh
  context, the rerun takes the ``DeviceMesh`` again (the same gradient).

Every rank sets a 60 s process-group timeout and destroys its group; the
ranks run under a subprocess timeout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import moe as RMOE
from repro_torch.configs import get_config
from repro_torch.models import moe as TMOE
from repro_torch.models.param import LayerParams
from tests.conftest import run_with_devices
from tests.test_torch_sharded_train import RANKS, spawn_ranks

B, S = 2, 64


RANK_CODE = r'''
import os
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
out_dir = os.environ["OUT"]
dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=60))
try:
    from repro_torch.launch import mesh as M
    from repro_torch.mesh_ctx import mesh_context
    from repro_torch.models import moe as TMOE
    from repro_torch.models.param import LayerParams

    inp = np.load(os.path.join(out_dir, "inputs.npz"))
    meta = {k: int(inp["meta_" + k]) for k in
            ("n_experts", "top_k", "d_expert", "d_model", "n_shared_experts")}
    mesh = M.make_smoke_mesh(2, 2, device_type="cpu")
    d, m = mesh.get_coordinate()
    s_loc = inp["x"].shape[1] // 2
    rows = slice(d, d + 1)
    out = {}
    # the path's own routing, recorded
    routed, route = [], TMOE._route

    def logged(logits, top_k):
        res = route(logits, top_k)
        routed.append(res[1])
        return res

    TMOE._route = logged
    for tag, cf in (("nodrop", 8.0), ("default", float(inp["cf_default"]))):
        routed.clear()
        layer = LayerParams({k: torch.from_numpy(inp["p_" + k]) for k in
                             ("router", "wg", "wu", "wd", "shared_wg",
                              "shared_wu", "shared_wd")})
        for t in layer.parameters():
            t.requires_grad_(True)
        x = torch.from_numpy(inp["x"][rows]).requires_grad_(True)
        with mesh_context(mesh):
            y, aux = TMOE.moe_forward(layer, x,
                                      dict(meta, capacity_factor=cf))
        loss = (y * torch.from_numpy(inp["ct"][rows])).sum() + aux
        loss.backward()
        out[f"{tag}_y"] = y.detach().numpy()
        out[f"{tag}_aux"] = aux.detach().numpy()
        out[f"{tag}_dx"] = x.grad.numpy()
        for k, t in layer.named_parameters():
            out[f"{tag}_d{k}"] = t.grad.numpy()
        # the slots and the kept mask of this rank's block of the path's
        # routing (one routing of the rows)
        assert len(routed) == 1
        top_i = routed[0][m * s_loc:(m + 1) * s_loc]
        T = top_i.shape[0]
        slot = TMOE._slots(top_i.reshape(-1), meta["n_experts"])
        C = TMOE._capacity(T, meta["top_k"], meta["n_experts"], cf)
        out[f"{tag}_slot"] = slot.numpy()
        out[f"{tag}_keep"] = (slot < C).numpy()
    TMOE._route = route
    # the expert stacks as DTensors placed on `model` (the rank's block
    # is the local shard): the same output, bit for bit
    from repro_torch.mesh_ctx import Sharding
    on_model = Sharding(mesh, ("model",))
    layer = LayerParams({k: torch.from_numpy(inp["p_" + k]) for k in
                         ("router", "wg", "wu", "wd", "shared_wg",
                          "shared_wu", "shared_wd")})
    for k in ("wg", "wu", "wd"):
        layer._parameters[k] = torch.nn.Parameter(
            on_model.place(layer[k].detach()), requires_grad=False)
    with torch.no_grad(), mesh_context(mesh):
        y, _ = TMOE.moe_forward(layer, torch.from_numpy(inp["x"][rows]),
                                dict(meta, capacity_factor=8.0))
    assert torch.equal(y, torch.from_numpy(out["nodrop_y"]))
    # under remat "block" the backward reruns the layer outside the
    # mesh context: the rerun takes the forward's DeviceMesh again
    from repro_torch.models.transformer import _remat
    layer = LayerParams({k: torch.from_numpy(inp["p_" + k]) for k in
                         ("router", "wg", "wu", "wd", "shared_wg",
                          "shared_wu", "shared_wd")})
    x = torch.from_numpy(inp["x"][rows]).requires_grad_(True)
    with mesh_context(mesh):
        y, aux = _remat(lambda x: TMOE.moe_forward(
            layer, x, dict(meta, capacity_factor=8.0)), "block")(x)
    ((y * torch.from_numpy(inp["ct"][rows])).sum() + aux).backward()
    assert torch.equal(y.detach(), torch.from_numpy(out["nodrop_y"]))
    torch.testing.assert_close(x.grad, torch.from_numpy(out["nodrop_dx"]),
                               rtol=1e-6, atol=1e-7)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    print("EP_RANK_OK", rank, d, m)
finally:
    dist.destroy_process_group()
'''

REFERENCE_EP = r'''
import numpy as np, jax, jax.numpy as jnp
from repro.launch import mesh as M
from repro.mesh_ctx import mesh_context
from repro.models.moe import moe_forward
inp = np.load("{path}")
meta = {{k: int(inp["meta_" + k]) for k in
        ("n_experts", "top_k", "d_expert", "d_model", "n_shared_experts")}}
p = {{k: jnp.asarray(inp["p_" + k]) for k in
     ("router", "wg", "wu", "wd", "shared_wg", "shared_wu", "shared_wd")}}
x = jnp.asarray(inp["x"])
mesh = M.make_smoke_mesh(2, 2)
out = {{}}
for tag, cf in (("nodrop", 8.0), ("default", float(inp["cf_default"]))):
    with mesh_context(mesh):
        y, aux = jax.jit(lambda p, x: moe_forward(
            p, x, dict(meta, capacity_factor=cf)))(p, x)
    out[tag + "_y"] = np.asarray(y)
    out[tag + "_aux"] = np.asarray(aux)
np.savez("{out}", **out)
print("REF_EP_OK")
'''


def _inputs(tmp_path):
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    moe = cfg.moe
    E, D, F = moe.n_experts, cfg.d_model, moe.d_expert
    Fs = F * moe.n_shared_experts
    rng = np.random.default_rng(0)
    w = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    # the tokens lean along v and expert 0's router column is v: most
    # tokens pick expert 0, which overflows at the default capacity
    v = rng.standard_normal(D) / np.sqrt(D)
    router = rng.standard_normal((D, E)) * 0.5
    router[:, 0] += 4 * v
    inp = {"p_router": router.astype(np.float32),
           "p_wg": w(E, D, F), "p_wu": w(E, D, F), "p_wd": w(E, F, D),
           "p_shared_wg": w(D, Fs), "p_shared_wu": w(D, Fs),
           "p_shared_wd": w(Fs, D),
           "x": (rng.standard_normal((B, S, D)) * 0.5 + v).astype(
               np.float32),
           "ct": rng.standard_normal((B, S, D)).astype(np.float32),
           "cf_default": np.float64(moe.capacity_factor),
           **{f"meta_{k}": np.int64(v) for k, v in (
               ("n_experts", E), ("top_k", moe.top_k), ("d_expert", F),
               ("d_model", D), ("n_shared_experts", moe.n_shared_experts))}}
    np.savez(tmp_path / "inputs.npz", **inp)
    return inp


def _meta(inp, cf):
    return {k: int(inp["meta_" + k]) for k in
            ("n_experts", "top_k", "d_expert", "d_model",
             "n_shared_experts")} | {"capacity_factor": cf}


def _by_data(tag: str, key: str, ranks: list) -> list:
    """``key`` of the ranks of data coordinate 0 and 1, after checking that
    the two ranks of ``model`` hold the same bits; rank r holds data
    coordinate r // 2, model coordinate r % 2."""
    for d in range(2):
        np.testing.assert_array_equal(ranks[2 * d][f"{tag}_{key}"],
                                      ranks[2 * d + 1][f"{tag}_{key}"])
    return [ranks[2 * d][f"{tag}_{key}"] for d in range(2)]


def _rows(tag: str, key: str, ranks: list) -> np.ndarray:
    """The ranks' (1, S, D) rows of ``key`` assembled into (B, S, D)."""
    return np.concatenate(_by_data(tag, key, ranks))


def rel(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def test_expert_parallel_exchange_across_four_ranks(tmp_path):
    inp = _inputs(tmp_path)
    outs = spawn_ranks(RANK_CODE, tmp_path)
    assert all("EP_RANK_OK" in o for o in outs)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(RANKS)]
    ref_out = tmp_path / "ref.npz"
    assert "REF_EP_OK" in run_with_devices(REFERENCE_EP.format(
        path=tmp_path / "inputs.npz", out=ref_out), n_devices=4)
    ref = np.load(ref_out)

    # the port's dense path on the whole batch, and its gradients
    layer = LayerParams({k[2:]: torch.from_numpy(v) for k, v in inp.items()
                         if k.startswith("p_")})
    for t in layer.parameters():
        t.requires_grad_(True)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y_dense, aux_dense = TMOE.moe_forward(layer, x, _meta(inp, 8.0))
    # the one scalar the ranks' average over `data` is the gradient of
    ((y_dense * torch.from_numpy(inp["ct"])).sum() / 2 + aux_dense).backward()

    y_ep = _rows("nodrop", "y", ranks)
    assert np.abs(y_ep - y_dense.detach().numpy()).max() < 2e-3
    assert rel(y_ep, ref["nodrop_y"]) < 1e-4
    for r in ranks:
        assert abs(float(r["nodrop_aux"]) - float(aux_dense)) < 1e-3
        assert abs(float(r["nodrop_aux"]) - float(ref["nodrop_aux"])) < 1e-3
    # gradients: each rank's token gradient is twice its rows' share; the
    # weights' averaged over `data`
    assert rel(_rows("nodrop", "dx", ranks) / 2, x.grad.numpy()) < 1e-4
    for k, t in layer.named_parameters():
        got = sum(_by_data("nodrop", f"d{k}", ranks)) / 2
        assert rel(got, t.grad.numpy()) < 1e-4, k

    # where pairs drop: the integer slots and kept mask equal the
    # reference's formula on each rank's block, the output the reference's
    cf = float(inp["cf_default"])
    dropped = 0
    for rank, r in enumerate(ranks):
        d, m = divmod(rank, 2)
        xb = inp["x"][d:d + 1, m * S // 2:(m + 1) * S // 2].reshape(
            -1, inp["x"].shape[-1])
        _, top_i, _ = RMOE._route(jnp.asarray(xb) @ jnp.asarray(
            inp["p_router"]), int(inp["meta_top_k"]))
        onehot = jax.nn.one_hot(top_i.reshape(-1), int(inp["meta_n_experts"]),
                                dtype=jnp.int32)
        slot = np.asarray(((jnp.cumsum(onehot, 0) - onehot) * onehot).sum(-1))
        C = RMOE._capacity(xb.shape[0], int(inp["meta_top_k"]),
                           int(inp["meta_n_experts"]), cf)
        np.testing.assert_array_equal(r["default_slot"], slot)
        np.testing.assert_array_equal(r["default_keep"], slot < C)
        dropped += int((slot >= C).sum())
    assert dropped > 0
    assert rel(_rows("default", "y", ranks), ref["default_y"]) < 1e-4
