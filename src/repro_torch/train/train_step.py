"""Training step: the trainable / frozen split of a ``TrainPolicy`` (the
paper's multimodal training stages), gradient accumulation, optional int8
gradient compression, the optimizer update — the reference's
``repro/train/train_step.py`` run eagerly on the parameters' device.

The reference compiles the step into one XLA program with ZeRO shardings
and donates the state; here the step is eager PyTorch:

* the trainable leaves are the ones with ``requires_grad``
  (:func:`~repro_torch.models.param.set_trainable`), and the gradients
  are taken for those alone (``torch.autograd.grad``), so a frozen
  tower records no graph and gets no gradient;
* the optimizer updates the parameters and its state in place, and the
  returned :class:`TrainState` holds the same tensors as the one passed
  in (the counterpart of the reference's donation); its state is keyed
  by the reference's leaves (``param.trainable_leaves``), a scanned
  module's layers stacked;
* with ``zero_shardings`` (a tree of ``mesh_ctx.Sharding``s in the
  reference's layout, from ``launch.mesh.zero_grad_shardings``) the step
  runs one process per device over their ``DeviceMesh``, as ZeRO-2 does:
  the parameters (``DTensor``s, placed by ``launch.mesh.param_shardings``)
  are gathered whole for the forward, the batch's leaves are this rank's
  rows (``DTensor``s placed by ``batch_shardings``), each gradient is put
  onto its ZeRO placement — averaged over the batch axes and scattered,
  the reference's ``_constrain`` — and the optimizer updates each rank's
  shard of the state (``DTensor``s placed by ``opt_shardings``).  A leaf
  whose state is laid out like its gradient (AdamW's m / v / master) is
  updated on the local shards; one whose state is not (Adafactor's
  factored moments, 8-bit Adam's flat blocks, which reduce over the whole
  leaf) is updated on the whole tensors and scattered back.  The updated
  parameters go back to their own placements (an all-gather over
  ``data``).  ``loss`` and ``xent`` are the batch's mean over the ranks.
  With ``None`` the step is the one-device step, unchanged.

:func:`init_train_state` builds the parameters on the card unless the
caller passes another device, as ``Model.init`` does.

The state's making and each step's forward (embeddings to loss), backward
(remat's recompute included) and optimizer (the update, the gradient
norm, the int8 compression) are phase spans (``device_metrics.span``):
``repro_torch.train.state``, ``.forward``, ``.backward``, ``.optimizer``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.core.device_metrics import span
from repro_torch.core.spec import TrainPolicy
from repro_torch.models import param as PM
from repro_torch.models.registry import Model
from repro_torch.train.optimizer import (OptimizerConfig, apply_updates,
                                         init_opt_state)


@dataclass
class TrainState:
    params: PM.ModuleParams   # full model params (compute dtype)
    opt: dict                 # optimizer state by the reference's leaf
    step: torch.Tensor        # int32 scalar on the params' device


def train_state(params: PM.ModuleParams, policy: TrainPolicy,
                opt_cfg: OptimizerConfig) -> TrainState:
    """The state of ready parameters (for example the reference's, carried
    across with ``Model.from_numpy``): the policy's leaves marked
    trainable, their optimizer state zeroed, step 0."""
    with span("repro_torch.train.state", phase=True):
        PM.set_trainable(params, policy)
        device = next(params.parameters()).device
        return TrainState(params=params,
                          opt=init_opt_state(PM.trainable_leaves(params),
                                             opt_cfg),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=device))


def init_train_state(model: Model, policy: TrainPolicy,
                     opt_cfg: OptimizerConfig, generator: torch.Generator,
                     device="cuda") -> TrainState:
    """Random parameters from ``generator`` (on ``device``, the card by
    default) and their train state."""
    return train_state(model.init(generator, device), policy, opt_cfg)


def _compress_grads_int8(grads: list) -> list:
    """Emulated wire compression: quantize / dequantize each gradient in
    its own type (the real deployment compresses the reduce-scatter
    payload; numerics match)."""
    out = []
    for g in grads:
        scale = g.abs().max().clamp_min(1e-12) / 127.0
        out.append(torch.round(g / scale).to(torch.int8).to(g.dtype) * scale)
    return out


def _global_norm(grads: list) -> torch.Tensor:
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads))


def make_train_step(model: Model, policy: TrainPolicy,
                    opt_cfg: OptimizerConfig, *,
                    grad_accum: int = 1,
                    zero_shardings: Any = None,
                    compress_grads: bool = False,
                    remat: Optional[str] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)`` with
    metrics ``loss``, ``xent`` and ``grad_norm`` (fp32 scalar tensors).

    ``batch`` leaves are (global_batch, ...); with ``grad_accum > 1`` they
    are split into ``grad_accum`` equal microbatches along dim 0, the
    gradients summed in fp32 and divided by ``grad_accum``.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def grads_of(params, leaves, batch):
        with span("repro_torch.train.forward", phase=True):
            loss, metrics = model.loss(params, batch, remat=remat)
        # a leaf the loss never reads (the blocks a hybrid config whose
        # depth attn_every does not divide leaves out, C16) gets a zero
        # gradient, as the reference's
        with span("repro_torch.train.backward", phase=True):
            grads = list(torch.autograd.grad(loss, leaves,
                                             materialize_grads=True))
        return loss.detach(), metrics, grads

    def loss_and_grads(params, trainable, batch):
        leaves = [p for _, p in trainable]
        if grad_accum == 1:
            loss, metrics, grads = grads_of(params, leaves, batch)
            return loss, {"xent": metrics["xent"]}, grads
        micro = {k: v.chunk(grad_accum, dim=0) for k, v in batch.items()}
        if any(len(v) != grad_accum or v[0].shape != v[-1].shape
               for v in micro.values()):
            raise ValueError(f"batch does not split into {grad_accum} "
                             f"equal microbatches")
        grads = [torch.zeros(p.shape, dtype=torch.float32,
                             device=p.device) for p in leaves]
        loss = 0.0
        for i in range(grad_accum):
            mb = {k: v[i] for k, v in micro.items()}
            mb_loss, _, mb_grads = grads_of(params, leaves, mb)
            for acc, g in zip(grads, mb_grads):
                acc.add_(g)
            loss = loss + mb_loss
            del mb_grads
        grads = [g / grad_accum for g in grads]
        loss = loss / grad_accum
        return loss, {"xent": loss}, grads

    def train_step(state: TrainState, batch: dict):
        if zero_shardings is not None:
            return _zero_step(state, batch)
        params = PM.set_trainable(state.params, policy)
        trainable = PM.trainable_params(params)
        loss, metrics, grads = loss_and_grads(params, trainable, batch)
        with span("repro_torch.train.optimizer", phase=True):
            if compress_grads:
                grads = _compress_grads_int8(grads)
            step = state.step + 1
            apply_updates(PM.group_leaves(params, trainable),
                          {n: g for (n, _), g in zip(trainable, grads)},
                          state.opt, step.to(torch.float32), opt_cfg)
            grad_norm = _global_norm(grads)
        metrics = dict(metrics, loss=loss, grad_norm=grad_norm)
        return TrainState(params=params, opt=state.opt, step=step), metrics

    def _zero_step(state: TrainState, batch: dict):
        from torch.distributed.tensor import DTensor
        params = PM.set_trainable(state.params, policy)
        if not all(isinstance(t, DTensor) for t in params.parameters()):
            raise ValueError("zero_shardings: the parameters are not placed "
                             "on a mesh (launch.mesh.place_train_state)")
        trainable = PM.trainable_params(params)
        whole = PM.map_params(params, _whole)
        local = {k: v.to_local() if isinstance(v, DTensor) else v
                 for k, v in batch.items()}
        loss, metrics, grads = loss_and_grads(
            whole, PM.trainable_params(whole), local)
        if compress_grads:
            with span("repro_torch.train.optimizer", phase=True):
                grads = _compress_grads_int8(grads)
        zero = {}
        for (name, _), g in zip(trainable, grads):
            sh = PM.sharding_of(zero_shardings, name)
            zero[name] = DTensor.from_local(
                g, sh.mesh, _batch_mean(sh.mesh), run_check=False
            ).redistribute(sh.mesh, sh.placements)
        del grads, whole
        mesh = next(iter(zero.values())).device_mesh if zero else None
        step = state.step + 1
        with span("repro_torch.train.optimizer", phase=True):
            with torch.no_grad():
                for leaf in PM.group_leaves(params, trainable):
                    _update_leaf(leaf, zero, state.opt[leaf.name],
                                 PM.sharding_of(zero_shardings, leaf.name),
                                 step.to(torch.float32), opt_cfg)
            grad_norm = torch.sqrt(sum(
                (torch.sum(torch.square(g.float())).full_tensor()
                 for g in zero.values()),
                torch.zeros((), device=state.step.device)))
        metrics = {k: _mean_over_batch(v, mesh) for k, v in metrics.items()}
        metrics = dict(metrics, loss=_mean_over_batch(loss, mesh),
                       grad_norm=grad_norm)
        return TrainState(params=params, opt=state.opt, step=step), metrics

    return train_step


def _whole(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a ``DTensor`` (gathered); a tensor as is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _batch_mean(mesh) -> list:
    """Placements of a value each rank computed on its own rows: the mean
    over the batch axes (``pod``, ``data``), the same on the others."""
    from torch.distributed.tensor import Partial, Replicate
    return [Partial("avg") if a in ("pod", "data") else Replicate()
            for a in mesh.mesh_dim_names]


def _mean_over_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    if mesh is None:
        return x
    return DTensor.from_local(x.reshape(()).to(torch.float32), mesh,
                              _batch_mean(mesh), run_check=False
                              ).full_tensor()


def _update_leaf(leaf, grads: dict, st: dict, zero, step, opt_cfg) -> None:
    """One leaf's update on a mesh: ``leaf`` of ``DTensor`` parameters,
    ``grads`` by name on their ZeRO placements, ``st`` its state
    (``DTensor``s), ``zero`` the leaf's ZeRO sharding (stacked)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = zero.mesh
    on_shards = all(isinstance(s, DTensor) and tuple(s.shape) == leaf.shape
                    and s.placements == zero.placements for s in st.values())
    if on_shards:
        src = [grads[n].placements for n, _ in leaf.params]
        views = [(n, p.redistribute(mesh, pl).to_local())
                 for (n, p), pl in zip(leaf.params, src)]
        state = {k: s.to_local() for k, s in st.items()}
        g = {n: grads[n].to_local() for n, _ in leaf.params}
    else:
        src = [(Replicate(),) * mesh.ndim] * len(leaf.params)
        views = [(n, p.full_tensor()) for n, p in leaf.params]
        state = {k: _whole(s) for k, s in st.items()}
        g = {n: grads[n].full_tensor() for n, _ in leaf.params}
    apply_updates([PM.Leaf(leaf.name, tuple(views), leaf.stacked)], g,
                  {leaf.name: state}, step, opt_cfg)
    for (_, p), (_, v), pl in zip(leaf.params, views, src):
        _write_local(p, DTensor.from_local(v, mesh, pl, run_check=False))
    if not on_shards:
        for k, s in st.items():
            if isinstance(s, DTensor):
                _write_local(s, DTensor.from_local(
                    state[k], mesh, (Replicate(),) * mesh.ndim,
                    run_check=False))
            else:
                s.copy_(state[k])


def _write_local(dst, src) -> None:
    """Write ``src`` (a ``DTensor`` of ``dst``'s shape) into ``dst``'s
    local shard, on ``dst``'s placements."""
    new = src.redistribute(dst.device_mesh, dst.placements).to_local()
    out = dst.to_local()
    if new.data_ptr() != out.data_ptr():
        out.copy_(new)
