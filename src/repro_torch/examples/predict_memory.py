"""The paper's workflow as a CLI: parse -> factorize -> predict -> verdict.

    PYTHONPATH=src python -m repro_torch.examples.predict_memory \
        --arch qwen3-32b --shape train_4k --data 16 --model 16
    PYTHONPATH=src python -m repro_torch.examples.predict_memory \
        --arch smollm-360m --shape long_500k --data 1 --model 1 \
        --validate --hbm-gib 80

``--validate`` additionally runs one real step of the same cell on the
card (``launch.measure.run_cell``: the allocator read around it) and
reports the prediction error against the step's peak — the paper's
evaluation, one cell at a time.  A card measures one device, so it needs
``--data 1 --model 1``; a cell the verdict calls OOM is refused before
anything is allocated.
"""

from __future__ import annotations

import argparse
from typing import Optional

GiB = 1024 ** 3


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.predict_memory")
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--data", type=int, default=16)
    ap.add_argument("--model", type=int, default=16)
    ap.add_argument("--policy", default="full",
                    choices=["full", "llava_stage1", "llava_stage2"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--backend", default="tpu", choices=["tpu", "cpu"])
    ap.add_argument("--hbm-gib", type=float, default=16.0)
    ap.add_argument("--validate", action="store_true")
    args = ap.parse_args(argv)
    if args.validate:
        if (args.data, args.model) != (1, 1):
            ap.error("--validate runs one step on one card, which measures "
                     "one device: pass --data 1 --model 1")
        if args.grad_accum != 1:
            ap.error("--validate measures one step without gradient "
                     "accumulation: pass --grad-accum 1")
        import torch
        if not torch.cuda.is_available():
            ap.error("--validate reads the CUDA caching allocator: it runs "
                     "on the card, and no CUDA device is available")

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import factors as FA
    from repro_torch.core import predictor as PR
    from repro_torch.core.parser import modules_of, parse_model, total_params
    from repro_torch.core.spec import FULL_TRAIN, LLAVA_STAGE1, LLAVA_STAGE2
    from repro_torch.launch import mesh as M
    from repro_torch.models import build_model

    policy = {"full": FULL_TRAIN, "llava_stage1": LLAVA_STAGE1,
              "llava_stage2": LLAVA_STAGE2}[args.policy]
    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    model = build_model(cfg)

    # workflow step 1-4: parse into modules and fine-grained layers
    rows = parse_model(model.spec, policy)
    mods = modules_of(rows)
    print(f"parsed {args.arch}: {len(mods)} modules, {len(rows)} layer "
          f"kinds, {total_params(rows) / 1e9:.2f}B params")

    # step 5-6: factorize + per-factor equations; step 7: aggregate (Eq.1)
    mesh_shape = {"data": args.data, "model": args.model}
    ctx = FA.PredictContext(
        mesh_shape=mesh_shape, rules=M.arch_rules(cfg, shape.kind),
        optimizer=cfg.optimizer, fsdp=cfg.fsdp, remat=cfg.remat,
        master_fp32=cfg.optimizer != "adafactor",
        global_batch=shape.global_batch, seq_len=shape.seq_len,
        enc_seq=int(shape.seq_len * cfg.encdec.enc_seq_ratio)
        if cfg.encdec else 0,
        kind=shape.kind, max_len=shape.seq_len,
        grad_accum=args.grad_accum, backend=args.backend)
    pred = PR.predict(model, policy, ctx)

    print(f"\nper-device prediction ({args.backend} oracle, mesh "
          f"data={args.data} x model={args.model}):")
    print(pred.summary())
    budget = args.hbm_gib * GiB * 0.92
    fits = pred.peak_bytes <= budget
    print(f"\nverdict: {'FITS' if fits else 'OOM'} "
          f"on a {args.hbm_gib:.0f} GiB chip "
          f"({pred.peak_bytes / GiB:.2f} vs budget {budget / GiB:.2f} GiB)")

    if args.validate:
        if not fits:
            raise SystemExit(f"OoM guard: refusing to launch a doomed job "
                             f"({pred.peak_bytes / GiB:.2f} GiB predicted, "
                             f"budget {budget / GiB:.2f} GiB)")
        from repro_torch.launch import measure as ME
        train = shape.kind == "train"
        cell = ME.MeasureCell(args.arch, shape.kind, shape.seq_len,
                              shape.global_batch, args.policy,
                              cfg.optimizer if train else None,
                              cfg.remat if train else None)
        run = ME.run_cell(cell)
        actual = run.memory.stats.total_bytes
        card = ME.card_identity()
        err = abs(pred.peak_bytes - actual) / actual * 100
        print(f"\nvalidation vs one step on the card ({card['name']}, "
              f"{card['power_limit']}, allocator peak): predicted "
              f"{pred.peak_bytes / GiB:.2f} GiB, actual "
              f"{actual / GiB:.2f} GiB, APE {err:.1f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
