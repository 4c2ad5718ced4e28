"""Capacity planning: sweep the full knob space before asking for quota.

    PYTHONPATH=src python -m repro_torch.examples.capacity_plan
    PYTHONPATH=src python -m repro_torch.examples.capacity_plan --device cpu

Three questions a training-platform scheduler asks the paper's estimator,
each answered by one memoized sweep (thousands of Eq.1 cells, no compile;
the torch engine composes them on the card, or on the host with
``--device cpu``):

1. What is the max global batch that fits llava15-7b stage-2 training on
   a 64-chip v5e slice, over every mesh factorization?
2. How many chips do we minimally need for batch 256?
3. Does a leaner optimizer (adafactor) or a bigger chip (v5p) change the
   answer?
"""

from __future__ import annotations

import argparse
from typing import Optional

GiB = 1024 ** 3


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.capacity_plan")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the torch engine composes the cells "
                         "(default: the card)")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("the torch engine runs on a CUDA device and none is "
                 "present; pass --device cpu to run on the host")
    from repro_torch.core import sweep as SW
    from repro_torch.core.spec import LLAVA_STAGE2

    engine = SW.SweepEngine()     # shared caches across all three sweeps

    def run(grid):
        return engine.sweep(grid, engine="torch", device=args.device)

    # 1. max fitting batch on 64 chips, every (data, model) factorization
    res = run(SW.SweepGrid(
        arch="llava15-7b", chips=64, chip="v5e",
        remats=(None, "none", "dots"),
        grad_accums=(1, 2, 4, 8),
        global_batches=(64, 128, 256, 512, 1024),
        seq_lens=(2048,),
        policy=LLAVA_STAGE2, backend="tpu"))
    print(f"sweep 1: {len(res)} cells in {res.elapsed_s * 1e3:.0f} ms "
          f"({res.cells_per_sec:,.0f} cells/s)")
    best = res.max_global_batch()
    print(f"  max batch on 64 v5e: {best}\n" if best
          else "  nothing fits 64 v5e\n")

    # 2. min chips for global batch 256 (sweep chip counts in one grid)
    res2 = run(SW.SweepGrid(
        arch="llava15-7b", chips=(16, 32, 64, 128, 256), chip="v5e",
        grad_accums=(1, 2, 4, 8), global_batches=(256,), seq_lens=(2048,),
        policy=LLAVA_STAGE2, backend="tpu"))
    least = res2.min_chips(global_batch=256)
    print(f"sweep 2: {len(res2)} cells in {res2.elapsed_s * 1e3:.0f} ms")
    print(f"  min chips for batch 256: {least}")
    print("  Pareto frontier (chips -> max batch):", res2.frontier(), "\n")

    # 3. cross-product with optimizer and chip type
    res3 = run(SW.SweepGrid(
        arch="llava15-7b", chips=32, chip=("v5e", "v5p", "h100"),
        optimizers=(None, "adafactor"),
        grad_accums=(1, 2, 4), global_batches=(128, 256), seq_lens=(2048,),
        policy=LLAVA_STAGE2, backend="tpu"))
    print(f"sweep 3: {len(res3)} cells in {res3.elapsed_s * 1e3:.0f} ms")
    for chip in ("v5e", "v5p", "h100"):
        b = res3.max_global_batch(chip=chip)
        print(f"  32x {chip:<5s}: " + (str(b) if b else "no fit"))
    print()
    print(res3.to_markdown(limit=10))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
