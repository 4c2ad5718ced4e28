"""Faults planted under the timed path, to show that the comparison
catches them: the step's own entry wrapped so that it

* ``frozen_state``: returns its state unchanged (the loss of a forward
  pass, no update);
* ``half_batch``: leaves out the second half of the batch, the mean taken
  over the rest;
* ``loss_altered``: reports a loss 1 % off where the step produces it.
"""

from __future__ import annotations

import torch

FAULTS = ("frozen_state", "half_batch", "loss_altered")


def plant(prog, fault: str) -> None:
    step = prog.step
    if fault == "frozen_state":
        def broken(state, batch):
            with torch.no_grad():
                loss, _ = prog.model.loss(state.params, batch)
            return state, {"loss": loss}
    elif fault == "half_batch":
        def broken(state, batch):
            return step(state, {k: v[:v.shape[0] // 2]
                                for k, v in batch.items()})
    elif fault == "loss_altered":
        def broken(state, batch):
            state, metrics = step(state, batch)
            return state, dict(metrics, loss=metrics["loss"] * 1.01)
    else:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    prog.step = broken
