"""End-to-end example: train a ~100M-param LLaVA-style multimodal model with
the FULL production stack — memory prediction first (the paper's
workflow), then fault-tolerant training with async checkpoints,
deterministic data, straggler detection and restart.

    PYTHONPATH=src python -m repro_torch.examples.train_llava_e2e [--steps 200]
    PYTHONPATH=src python -m repro_torch.examples.train_llava_e2e \
        --steps 3 --device cpu

Training runs on the card unless ``--device cpu`` asks for the host; the
weights come from a seeded generator.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Optional

GiB = 1024 ** 3


def llava_100m():
    """~100M-param LLaVA-style config (real ViT tower + projector + LM)."""
    from repro_torch.configs import VLMConfig, get_config
    base = get_config("llava15-7b")
    return dataclasses.replace(
        base, name="llava-100m",
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
        vocab=32000, head_dim=64,
        vlm=VLMConfig(d_vision=256, n_image_tokens=64, projector_layers=2,
                      vision_tower=True, vit_layers=4, vit_heads=4,
                      vit_d_ff=1024, vit_patch=14, vit_image_size=112))


def main(argv: Optional[list] = None) -> dict:
    """Returns the trainer's history and the checkpoint directory."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_llava_e2e")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    # total sequence = 64 image tokens + text; keep text non-degenerate
    ap.add_argument("--seq", type=int, default=192)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where training runs (default: the card)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "directory)")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is present; pass --device cpu to train on "
                 "the host")
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import factors as FA
    from repro_torch.core import predictor as PR
    from repro_torch.core.spec import LLAVA_STAGE2
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import build_model
    from repro_torch.models import param as PM
    from repro_torch.models.param import TORCH_DTYPES
    from repro_torch.runtime import FaultConfig, ResilientTrainer
    from repro_torch.train import (OptimizerConfig, init_train_state,
                                   make_train_step)

    cfg = llava_100m()
    model = build_model(cfg)
    shape = ShapeConfig("e2e", args.seq, args.batch, "train")
    policy = LLAVA_STAGE2                       # vision tower frozen

    # 1. paper workflow: predict memory BEFORE training
    ctx = FA.PredictContext(mesh_shape={}, optimizer="adamw",
                            global_batch=args.batch, seq_len=args.seq,
                            kind="train", backend="cpu")
    pred = PR.predict(model, policy, ctx)
    print(f"predicted peak memory: {pred.peak_bytes / GiB:.2f} GiB "
          f"(params {pred.param_bytes / GiB:.2f}, "
          f"opt {pred.opt_bytes / GiB:.2f})")
    for mod, parts in pred.per_module.items():
        if parts["param"]:
            tag = "trainable" if parts["trainable"] else "FROZEN"
            print(f"  {mod:<42s} {tag:>9s} "
                  f"param {parts['param'] / GiB:6.3f} GiB "
                  f"opt {parts['opt'] / GiB:6.3f} GiB")

    # 2. build the training state (the policy's leaves trainable)
    dev = torch.device(args.device)
    opt_cfg = OptimizerConfig(name="adamw", lr=3e-4)
    state = init_train_state(model, policy, opt_cfg,
                             torch.Generator(dev).manual_seed(0), dev)
    n = PM.count_params(state.params)
    print(f"\nmodel: {cfg.name}, {n / 1e6:.1f}M params")

    # 3. fault-tolerant training loop (async ckpt, restart, stragglers)
    pipe = SyntheticPipeline(cfg, shape, n_shards=2)
    step_fn = make_train_step(model, policy, opt_cfg)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_llava_e2e_")
    spec = model.batch_spec(shape)
    trainer = ResilientTrainer(
        train_step=step_fn, pipeline=pipe,
        checkpointer=Checkpointer(ckpt_dir, keep=2),
        fault_cfg=FaultConfig(ckpt_every=50),
        # a float leaf in its batch_spec type (the image patches in bf16)
        make_batch=lambda s: {
            k: torch.from_numpy(v).to(dev, TORCH_DTYPES.get(spec[k].dtype))
            for k, v in pipe.global_batch(s).items()})
    state, history = trainer.run(state, start_step=0, n_steps=args.steps,
                                 log_every=20)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    print(f"checkpoints in {ckpt_dir}")
    return {"history": history, "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
