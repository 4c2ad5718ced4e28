"""Production training launcher: the paper's workflow end-to-end — the
reference's ``repro/launch/train.py`` on the port.

    python -m repro_torch.launch.train --arch smollm-360m --shape train_4k \
        --grad-accum 16 --steps 3           # on the card
    python -m repro_torch.launch.train --arch llama3.2-3b --steps 100 \
        --reduced --device cpu              # a runnable smoke on the host
    python -m repro_torch.launch.train --arch qwen3-32b --shape train_4k \
        --check-only                        # OoM guard on the target mesh

Flow: predict peak memory on the TARGET mesh (the OoM guard refuses a
doomed launch) -> build the mesh and shardings -> fault-tolerant training
loop (async checkpoints, restart, straggler mitigation) over the
deterministic ``SyntheticPipeline``.  The prediction and the guard are
host arithmetic and touch no device.  Training runs on the card
(``--device cuda``, the default) unless the caller asks for the host with
``--device cpu``; with no card and no ``--device cpu`` the launch raises.
As the reference builds a mesh only when more than one device is present,
the port builds one only in a ``torch.distributed`` world of more than
one process, one per device — a group the caller started, or under
``torchrun`` (``WORLD_SIZE`` > 1) one the launcher starts from its env://
rendezvous: then the parameters, optimizer state and batches are placed
with ``launch.mesh``'s shardings and the step runs with ZeRO shardings.
That mesh is the reference's: ``data`` is ``min(--data, world)`` and
``model`` the rest of the world; ``--data`` and ``--model`` otherwise name
the target mesh the planner predicts for.
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class Launch:
    """What :func:`main` did: the planner's report, and after training the
    final state, the trainer's history, the trainer itself and each step's
    seconds (host clock around a step that ends in a device
    synchronize)."""

    report: Any
    state: Any = None
    history: Optional[list] = None
    trainer: Any = None
    step_s: Optional[list] = None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config + tiny batch (CPU smoke)")
    ap.add_argument("--check-only", action="store_true",
                    help="run the OoM guard for the production mesh, exit")
    ap.add_argument("--data", type=int, default=16)
    ap.add_argument("--model", type=int, default=16)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where training runs (default: the card)")
    return ap


def main(argv: Optional[list] = None) -> Launch:
    args = _parser().parse_args(argv)

    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.core import planner

    mesh_shape = {"data": args.data, "model": args.model}

    # ---- step 1: the paper — predict BEFORE launching --------------------
    report = planner.plan(args.arch, args.shape, mesh_shape, backend="tpu")
    print(report)
    if args.check_only:
        return Launch(report)
    if not report.fits and not args.reduced:
        raise SystemExit("OoM guard: refusing to launch a doomed job "
                         "(use the planner's suggestion or --reduced)")

    # ---- step 2: build and train -----------------------------------------
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.spec import FULL_TRAIN
    from repro_torch.data import SyntheticPipeline
    from repro_torch.launch import mesh as M
    from repro_torch.mesh_ctx import mesh_context
    from repro_torch.models import build_model, param as PM
    from repro_torch.runtime import FaultConfig, ResilientTrainer
    from repro_torch.train import (OptimizerConfig, init_train_state,
                                   make_train_step)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch.train: no CUDA device; pass --device cpu "
                           "to train on the host")
    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig("smoke", 64, 4, "train")
    model = build_model(cfg)
    opt_cfg = OptimizerConfig(name=cfg.optimizer,
                              master_fp32=cfg.optimizer != "adafactor")

    started = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 \
            and not dist.is_initialized():
        # one process per device under torchrun: its env:// rendezvous
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            device = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        started = True
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = None
    if world > 1:
        d = min(args.data, world)
        mesh = M.make_smoke_mesh(d, max(world // d, 1),
                                 device_type=device.type)

    with mesh_context(mesh, M.arch_rules(cfg) if mesh else None):
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        state = init_train_state(model, FULL_TRAIN, opt_cfg, gen, device)
        zero, bsh = None, None
        if mesh is not None:
            mask = PM.trainable_mask(model.spec, FULL_TRAIN)
            t_specs, _ = PM.partition_params(model.param_specs(), mask)
            t_axes, _ = PM.partition_params(model.param_axes(), mask)
            M.place_train_state(
                state, M.param_shardings(model, mesh),
                M.opt_shardings(model, mesh, t_specs, opt_cfg, t_axes))
            zero = M.zero_grad_shardings(mesh, t_specs, t_axes)
            bsh = M.batch_shardings(mesh, model.batch_spec(shape))
        where = dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh \
            else "single-device"
        print(f"launch: {cfg.name} ({PM.count_params(state.params) / 1e6:.1f}M"
              f" params), mesh={where}, optimizer={opt_cfg.name}, "
              f"grad_accum={args.grad_accum}, device={device.type}")

        pipe = SyntheticPipeline(cfg, shape)
        step_fn = make_train_step(model, FULL_TRAIN, opt_cfg,
                                  grad_accum=args.grad_accum,
                                  zero_shardings=zero)
        step_s = []

        def timed_step(state, batch):
            t0 = time.perf_counter()
            out = step_fn(state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_s.append(time.perf_counter() - t0)
            return out

        def make_batch(step: int) -> dict:
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in pipe.global_batch(step).items()}
            return batch if bsh is None else \
                {k: bsh[k].place(v) for k, v in batch.items()}

        trainer = ResilientTrainer(
            train_step=timed_step, pipeline=pipe,
            checkpointer=Checkpointer(args.ckpt_dir, keep=3),
            fault_cfg=FaultConfig(ckpt_every=max(args.steps // 4, 10)),
            make_batch=make_batch)
        state, history = trainer.run(state, 0, args.steps,
                                     log_every=max(args.steps // 5, 1))
    print(f"done: loss {history[0]['loss']:.3f} -> "
          f"{history[-1]['loss']:.3f} over {args.steps} steps; "
          f"checkpoints in {args.ckpt_dir}")
    if started:
        dist.destroy_process_group()
    return Launch(report, state, history, trainer, step_s)


if __name__ == "__main__":
    main()
