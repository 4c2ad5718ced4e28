"""Training step: the trainable / frozen split of a ``TrainPolicy`` (the
paper's multimodal training stages), gradient accumulation, optional int8
gradient compression, the optimizer update — the reference's
``repro/train/train_step.py`` run eagerly on the parameters' device.

The reference compiles the step into one XLA program with ZeRO shardings
and donates the state; here the step is eager PyTorch on one device:

* the trainable leaves are the ones with ``requires_grad``
  (:func:`~repro_torch.models.param.set_trainable`), and the gradients
  are taken for those alone (``torch.autograd.grad``), so a frozen
  tower records no graph and gets no gradient;
* the optimizer updates the parameters and its state in place, and the
  returned :class:`TrainState` holds the same tensors as the one passed
  in (the counterpart of the reference's donation); its state is keyed
  by the reference's leaves (``param.trainable_leaves``), a scanned
  module's layers stacked;
* ``zero_shardings`` has no meaning on one device: only ``None`` is
  taken.

:func:`init_train_state` builds the parameters on the card unless the
caller passes another device, as ``Model.init`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

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
    if zero_shardings is not None:
        raise ValueError("zero_shardings: the port's train step runs on one "
                         "device, where ZeRO shardings have no meaning; pass "
                         "None")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def grads_of(params, leaves, batch):
        loss, metrics = model.loss(params, batch, remat=remat)
        # a leaf the loss never reads (the blocks a hybrid config whose
        # depth attn_every does not divide leaves out, C16) gets a zero
        # gradient, as the reference's
        return loss.detach(), metrics, list(torch.autograd.grad(
            loss, leaves, materialize_grads=True))

    def train_step(state: TrainState, batch: dict):
        params = PM.set_trainable(state.params, policy)
        trainable = PM.trainable_params(params)
        leaves = [p for _, p in trainable]
        if grad_accum == 1:
            loss, metrics, grads = grads_of(params, leaves, batch)
            metrics = {"xent": metrics["xent"]}
        else:
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
            metrics = {"xent": loss}
        if compress_grads:
            grads = _compress_grads_int8(grads)
        step = state.step + 1
        apply_updates(PM.group_leaves(params, trainable),
                      {n: g for (n, _), g in zip(trainable, grads)},
                      state.opt, step.to(torch.float32), opt_cfg)
        metrics = dict(metrics, loss=loss, grad_norm=_global_norm(grads))
        return TrainState(params=params, opt=state.opt, step=step), metrics

    return train_step
