"""Serve a small model with batched requests: prefill + batched greedy
decode with KV-cache — including the paper-§5 'future work' the reference
built: predicting SERVING memory (weights + KV cache + decode transients)
before admitting a batch.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu

The model (the reduced smollm-360m, weights from a seeded generator) runs
on the card unless ``--device cpu`` asks for the host.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

GiB = 1024 ** 3
MiB = 1024 ** 2


def admission_check(model, batch_size: int, max_len: int,
                    hbm_bytes: int = 16 * GiB) -> bool:
    """Predict serving memory for a candidate batch (paper Eq.1, serve
    mode) and admit only if it fits."""
    from repro_torch.core import factors as FA
    from repro_torch.core import predictor as PR
    from repro_torch.core.spec import FULL_TRAIN
    ctx = FA.PredictContext(mesh_shape={}, kind="decode",
                            global_batch=batch_size, seq_len=max_len,
                            max_len=max_len, backend="tpu")
    pred = PR.predict(model, FULL_TRAIN, ctx)
    print(f"  admission: B={batch_size:<4d} max_len={max_len:<6d} -> "
          f"weights {pred.param_bytes / MiB:8.1f} MiB + "
          f"kv {pred.cache_bytes / MiB:8.1f} MiB + "
          f"transients {(pred.act_transient_bytes + pred.loss_bytes) / MiB:7.1f} MiB "
          f"= {pred.peak_bytes / MiB:8.1f} MiB "
          f"{'ADMIT' if pred.peak_bytes < hbm_bytes else 'REJECT'}")
    return pred.peak_bytes < hbm_bytes


def main(argv: Optional[list] = None) -> dict:
    """Returns the prompts and generated tokens (host tensors) and the
    generation's seconds."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_batched")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is present; pass --device cpu to serve on "
                 "the host")
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import generate

    dev = torch.device(args.device)
    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)

    print("== serving-memory admission control (paper §5, built) ==")
    for b, ml in ((8, 2048), (64, 8192), (512, 131072)):
        admission_check(model, b, ml)

    print("\n== batched greedy generation ==")
    B, S = 4, 24
    prompts = torch.randint(0, cfg.vocab, (B, S),
                            generator=torch.Generator(dev).manual_seed(7),
                            device=dev, dtype=torch.int32)
    out = generate(model, params, {"tokens": prompts}, max_new_tokens=16,
                   device=dev).cpu()
    for i in range(B):
        print(f"  request {i}: prompt {prompts[i, :6].tolist()}... -> "
              f"generated {out[i].tolist()}")

    # throughput-ish numbers (reduced model — a demo of the machinery)
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        generate(model, params, {"tokens": prompts}, max_new_tokens=16,
                 device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) / n
    print(f"\n{B} requests x 16 tokens in {dt:.2f}s "
          f"({B * 16 / dt:.1f} tok/s on {dev.type}, reduced config)")
    return {"prompts": prompts.cpu(), "tokens": out, "seconds": dt,
            "vocab": cfg.vocab}


if __name__ == "__main__":
    main()
