"""The program under test (the ``repro_torch`` package) as a training
cell drives it: its model built from the configuration file, its
parameters the benchmark's weights (views of the flat buffer, loaded by
name), its train state and its training step, the entry users call.

The readings the comparison takes from the program come from its
optimizer's state (AdamW: ``m``, ``master``, keyed by the program's
leaves, a stack of layers per leaf of a scanned module)."""

from __future__ import annotations

import torch

from perfbench.reference.common import leaf_of


class Program:
    def __init__(self, cfg: dict, adapter, weights: dict):
        from repro_torch.core import spec as S
        from repro_torch.models import param as PM
        from repro_torch.models.registry import build_model
        from repro_torch.train import (OptimizerConfig, make_train_step,
                                       train_state)
        t = cfg["training"]
        self.model = build_model(adapter.arch_config(cfg))
        params = self.model.init(torch.Generator(), "meta")
        params.load_state_dict(weights, strict=True, assign=True)
        policy = getattr(S, t["program_policy"])
        opt_cfg = OptimizerConfig(
            name=t["optimizer"], lr=t["lr"], b1=t["b1"], b2=t["b2"],
            eps=t["eps"], weight_decay=t["weight_decay"],
            master_fp32=t["master_fp32"])
        self.state = train_state(params, policy, opt_cfg)
        self.step = make_train_step(self.model, policy, opt_cfg,
                                    remat=t["remat"])
        self.leaves = {leaf.name: [n for n, _ in leaf.params]
                       for leaf in PM.trainable_leaves(params)}
        for name, names in self.leaves.items():
            if any(leaf_of(n) != name for n in names):
                raise ValueError(f"the program's leaf {name} holds "
                                 f"{names[:2]}...")

    def trainable(self) -> set:
        return {n for n, p in self.state.params.named_parameters()
                if p.requires_grad}

    def run(self, batch: dict):
        """One step; its loss as a tensor (the step's own output)."""
        self.state, metrics = self.step(self.state, batch)
        return metrics["loss"]

    def first_grad_norms(self, b1: float) -> dict:
        """Each leaf's gradient norm at step 1, from AdamW's first moment
        after that step (m = (1 - b1) g)."""
        return {name: float(self.state.opt[name]["m"].float().norm())
                / (1.0 - b1) for name in self.leaves}

    def change_norms(self, initial: dict) -> dict:
        """Each leaf's change since ``initial`` (name -> the weight as
        drawn), from the fp32 master copy the next step reads."""
        out = {}
        for name, names in self.leaves.items():
            master = self.state.opt[name]["master"]
            sq = 0.0
            for i, n in enumerate(names):
                cur = master[i] if len(names) > 1 or \
                    master.dim() > initial[n].dim() else master
                sq += float((cur - initial[n].float()).pow(2).sum())
            out[name] = sq ** 0.5
        return out
