"""The command line of run.py: one run of one cell on the card."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback


FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules (or of ``names``) that the
    benchmark's process may not hold, compared whole (``repro_torch`` is
    not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({k.split(".")[0] for k in names} & set(FORBIDDEN))


def _log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv: list, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
        from perfbench.harness import cell as CELL
        cell = CELL.load(args.workload)
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            _log(f"{args.workload} needs {cell.chips} CUDA device(s); this "
                 f"machine has {torch.cuda.device_count()}")
            return 2
        _log(f"card: {_card_line()}; torch {torch.__version__}")
        import repro_torch  # noqa: F401  (the program: missing -> fail)
        from repro_torch.kernels import _build
        t = time.perf_counter()
        _build.load()
        _log(f"kernel library ready in {time.perf_counter() - t:.3f} s "
             f"(build {_build.build_seconds:.3f} s)")
        from perfbench.harness import train
        result = train.run(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", t0)
        found = forbidden_modules()      # the window has closed
        if found:
            _log(f"the process holds {found}: no result")
            return 3
    except Exception:                       # report, print no result
        traceback.print_exc()
        return 1
    for name, c in result["checks"].items():
        _log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
