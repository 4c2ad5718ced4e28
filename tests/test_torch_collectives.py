"""The collectives block of the step counter across processes.

Four gloo ranks (separate processes over a ``FileStore`` in ``tmp_path``)
form the (2, 2) ``data, model`` mesh of ``launch.mesh.make_smoke_mesh``;
each runs under a ``core.device_metrics.StepCounter`` and writes what it
counted.  The counts, result bytes and ring wire bytes (all-reduce
2(g-1)/g, all-gather / reduce-scatter / all-to-all (g-1)/g of the result)
equal those worked out here:

* the ZeRO step of the reduced smollm-360m (bf16, AdamW), from each
  parameter's placements (``param_shardings``) and its gradient's ZeRO
  placements (``zero_grad_shardings``):

  - the whole parameter gathered for the forward (``full_tensor``): one
    all-gather over ``model`` of the whole parameter's bytes, for each
    parameter split on ``model``;
  - the gradient, a mean over ``data`` (``Partial(avg)``) redistributed to
    its ZeRO placements: one reduce-scatter over ``data``.  Its result is
    the gradient's block on ``data`` (the whole over the ``data`` size),
    or, where ``data`` splits the same tensor dim after ``model`` (a
    ``_StridedShard``), the ZeRO shard itself: DTensor takes the
    ``model`` block locally first;
  - the updated shard written back to the parameter's placements: one
    all-gather over ``data`` of the parameter's local bytes;
  - the gradient norm: one all-reduce of an fp32 scalar per mesh dim the
    ZeRO placements split (the sum of a shard is partial there);
  - the metrics (``xent``) and the loss, each averaged over ``data``: one
    all-reduce of an fp32 scalar each.

* the expert-parallel forward of the reduced deepseek-v2-lite-16b's MoE
  layer (fp32), from the calls ``models/moe.py`` issues per layer: the
  dispatch buffers (E, C, D) sent and received back (two all-to-alls over
  ``model``), the sequence blocks gathered back into the rank's rows (an
  all-gather over ``model``), and the routing probabilities (T, E) fp32
  and expert ids (T, k) int64 gathered over ``data`` for the aux loss.

Every rank sets a 60 s process-group timeout and destroys its group.
"""

import json

import pytest

from tests.test_torch_sharded_train import RANK_PRELUDE, spawn_ranks

COUNTED = r'''
from repro_torch.core import device_metrics as DM

def dump(counter, extra):
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(dict(DM.cost_blocks(counter)["collectives"], **extra), f)
'''

ZERO_STEP = RANK_PRELUDE + COUNTED + r'''
try:
    from torch.distributed.tensor import Shard
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.spec import FULL_TRAIN
    from repro_torch.launch import mesh as M
    from repro_torch.mesh_ctx import mesh_context
    from repro_torch.models import build_model, param as PM
    from repro_torch.train import OptimizerConfig, make_train_step, train_state

    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg)
    opt_cfg = OptimizerConfig()
    shape = ShapeConfig("t", 32, 4, "train")
    mesh = M.make_smoke_mesh(2, 2, device_type="cpu")

    def placements(pl):
        return [[type(p).__name__, getattr(p, "dim", None)] for p in pl]

    with mesh_context(mesh, M.arch_rules(cfg)):
        psh = M.param_shardings(model, mesh)
        mask = PM.trainable_mask(model.spec, FULL_TRAIN)
        t_specs, _ = PM.partition_params(model.param_specs(), mask)
        t_axes, _ = PM.partition_params(model.param_axes(), mask)
        osh = M.opt_shardings(model, mesh, t_specs, opt_cfg, t_axes)
        zsh = M.zero_grad_shardings(mesh, t_specs, t_axes)
        bsh = M.batch_shardings(mesh, model.batch_spec(shape))
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        state = M.place_train_state(train_state(params, FULL_TRAIN, opt_cfg),
                                    psh, osh)
        g = torch.Generator().manual_seed(1)
        batch = {k: bsh[k].place(torch.randint(0, cfg.vocab, (4, 32),
                                               generator=g,
                                               dtype=torch.int32))
                 for k in ("tokens", "labels")}
        step = make_train_step(model, FULL_TRAIN, opt_cfg,
                               zero_shardings=zsh)
        with DM.StepCounter() as counter:
            state, metrics = step(state, batch)
        leaves = [{"name": n, "bytes": p.numel() * p.element_size(),
                   "local_bytes": p.to_local().numel() * p.element_size(),
                   "param": placements(p.placements),
                   "zero": placements(PM.sharding_of(zsh, n).placements)}
                  for n, p in state.params.named_parameters()]
    dump(counter, {"leaves": leaves, "mesh": list(mesh.shape),
                   "names": list(mesh.mesh_dim_names),
                   "metrics": sorted(k for k in metrics
                                     if k not in ("loss", "grad_norm"))})
finally:
    dist.destroy_process_group()
'''

MOE_FORWARD = RANK_PRELUDE + COUNTED + r'''
try:
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.mesh_ctx import mesh_context
    from repro_torch.models import moe as TMOE
    from repro_torch.models.param import LayerParams

    cfg = get_config("deepseek-v2-lite-16b").reduced()
    E, k, F_, D = (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert,
                   cfg.d_model)
    g = torch.Generator().manual_seed(0)
    layer = LayerParams({
        "router": torch.randn((D, E), generator=g) * 0.1,
        "wg": torch.randn((E, D, F_), generator=g) * 0.1,
        "wu": torch.randn((E, D, F_), generator=g) * 0.1,
        "wd": torch.randn((E, F_, D), generator=g) * 0.1,
        "shared_wg": torch.randn((D, F_), generator=g) * 0.1,
        "shared_wu": torch.randn((D, F_), generator=g) * 0.1,
        "shared_wd": torch.randn((F_, D), generator=g) * 0.1})
    meta = {"n_experts": E, "top_k": k, "d_expert": F_, "d_model": D,
            "n_shared_experts": cfg.moe.n_shared_experts,
            "capacity_factor": cfg.moe.capacity_factor}
    mesh = M.make_smoke_mesh(2, 2, device_type="cpu")
    d, _ = mesh.get_coordinate()
    x = torch.randn((2, int(os.environ["SEQ"]), D), generator=g)[d:d + 1]
    with torch.no_grad(), mesh_context(mesh), DM.StepCounter() as counter:
        y, aux = TMOE.moe_forward(layer, x, meta)
    assert y.shape == x.shape and torch.isfinite(aux)
    dump(counter, {"rows": list(x.shape), "experts": E, "top_k": k,
                   "capacity_factor": cfg.moe.capacity_factor})
finally:
    dist.destroy_process_group()
'''


def ring(kind: str, nbytes: int, g: int) -> int:
    """The reference's ring terms (``xla_metrics.collective_stats``)."""
    if kind == "all-reduce":
        return int(2 * nbytes * (g - 1) / g)
    return int(nbytes * (g - 1) / g)


class Want:
    def __init__(self):
        self.counts, self.operand, self.wire = {}, {}, {}

    def add(self, kind: str, nbytes: int, g: int):
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.operand[kind] = self.operand.get(kind, 0) + nbytes
        self.wire[kind] = self.wire.get(kind, 0) + ring(kind, nbytes, g)

    def check(self, got: dict):
        assert got["counts"] == self.counts
        assert got["operand_bytes_per_device"] == self.operand
        assert got["wire_bytes_per_device"] == self.wire
        assert got["total_wire_bytes_per_device"] == sum(self.wire.values())


def _split(p) -> bool:
    return p[0] in ("Shard", "_StridedShard")


def zero_step_want(rec: dict) -> Want:
    sizes = dict(zip(rec["names"], rec["mesh"]))
    data, model = rec["names"].index("data"), rec["names"].index("model")
    want = Want()
    for leaf in rec["leaves"]:
        param, zero = leaf["param"], leaf["zero"]
        assert not _split(param[data])          # no FSDP on smollm
        if _split(param[model]):
            want.add("all-gather", leaf["bytes"], sizes["model"])
        if _split(zero[data]):
            blocks = sizes["data"] * (sizes["model"] if (
                zero[data][0] == "_StridedShard" and _split(zero[model]))
                else 1)
            assert leaf["bytes"] % blocks == 0
            want.add("reduce-scatter", leaf["bytes"] // blocks,
                     sizes["data"])
            want.add("all-gather", leaf["local_bytes"], sizes["data"])
        else:
            want.add("all-reduce", leaf["bytes"], sizes["data"])
        for i, p in enumerate(zero):
            if _split(p):
                want.add("all-reduce", 4, rec["mesh"][i])
    for _ in rec["metrics"] + ["loss"]:
        want.add("all-reduce", 4, sizes["data"])
    return want


def test_zero_step_collectives_follow_the_placements(tmp_path):
    spawn_ranks(ZERO_STEP, tmp_path)
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(4)]
    for rec in recs:
        assert rec["names"] == ["data", "model"] and rec["mesh"] == [2, 2]
        want = zero_step_want(rec)
        assert want.counts["reduce-scatter"] == len(rec["leaves"]) == 20
        want.check(rec)
    # every rank issues the same collectives
    assert all(r["counts"] == recs[0]["counts"] for r in recs)


@pytest.mark.parametrize("seq", [64, 128])
def test_expert_parallel_forward_collectives_follow_the_calls(seq,
                                                              tmp_path):
    from repro_torch.models import moe as TMOE
    spawn_ranks(MOE_FORWARD, tmp_path, env={"SEQ": str(seq)})
    for r in range(4):
        rec = json.loads((tmp_path / f"rank{r}.json").read_text())
        B, S, D = rec["rows"]
        E, k = rec["experts"], rec["top_k"]
        ep = dp = 2
        C = TMOE._capacity(B * S // ep, k, E, rec["capacity_factor"])
        want = Want()
        for _ in range(2):              # to the experts' ranks and back
            want.add("all-to-all", E * C * D * 4, ep)
        want.add("all-gather", B * S * D * 4, ep)       # the rows' blocks
        want.add("all-gather", dp * B * S * E * 4, dp)  # routing probs
        want.add("all-gather", dp * B * S * k * 8, dp)  # expert ids
        want.check(rec)
