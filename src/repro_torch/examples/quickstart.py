"""Quickstart: predict a training job's peak memory BEFORE launching it.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

The 30-second version of the paper: pick a model + hyperparameters, get a
per-device peak-memory prediction and an OoM verdict for the target mesh —
no profiling run, no compile, microseconds of arithmetic on the host.
"""

from __future__ import annotations

import argparse
from typing import Optional

GiB = 1024 ** 3


def main(argv: Optional[list] = None) -> int:
    argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart").parse_args(argv)
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import factors as FA
    from repro_torch.core import planner
    from repro_torch.core import predictor as PR
    from repro_torch.core.spec import FULL_TRAIN, LLAVA_STAGE1, LLAVA_STAGE2
    from repro_torch.launch import mesh as M
    from repro_torch.models import build_model

    # 1. peak memory for llama3.2-3b training on the production mesh
    cfg = get_config("llama3.2-3b")
    model = build_model(cfg)
    shape = SHAPES["train_4k"]
    ctx = FA.PredictContext(
        mesh_shape={"data": 16, "model": 16},
        rules=M.arch_rules(cfg, "train"),
        optimizer=cfg.optimizer, remat=cfg.remat, backend="tpu",
        global_batch=shape.global_batch, seq_len=shape.seq_len,
        kind="train")
    pred = PR.predict(model, FULL_TRAIN, ctx)
    print(f"== {cfg.name} x {shape.name} on (data=16, model=16), "
          f"per device ==")
    print(pred.summary())

    # 2. the multimodal factorization (the paper's core): the training
    #    behaviour changes memory — LLaVA stage-1 vs stage-2 vs full
    vlm = build_model(get_config("llava15-7b"))
    vctx = FA.PredictContext(mesh_shape={"data": 8}, optimizer="adamw",
                             global_batch=16, seq_len=1024, kind="train",
                             backend="tpu")
    print("\n== LLaVA-1.5-7B, DP=8: memory depends on the TRAINING "
          "BEHAVIOUR ==")
    for policy in (LLAVA_STAGE1, LLAVA_STAGE2, FULL_TRAIN):
        p = PR.predict(vlm, policy, vctx)
        print(f"  {policy.name:<14s} peak {p.peak_bytes / GiB:7.2f} GiB "
              f"(opt {p.opt_bytes / GiB:6.2f}, grads "
              f"{p.grad_bytes / GiB:6.2f}, acts "
              f"{p.act_saved_bytes / GiB:6.2f})")

    # 3. the OoM guard + planner
    print("\n== OoM guard: arctic-480b train_4k on a 16 GiB v5e ==")
    report = planner.plan("arctic-480b", "train_4k",
                          {"data": 16, "model": 16}, backend="tpu")
    print(report)
    adam = planner.adam_state_bytes("arctic-480b")
    print(f"(fyi: plain Adam would need {adam / GiB:.0f} GiB of optimizer "
          f"state — more than the whole pod's HBM)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
