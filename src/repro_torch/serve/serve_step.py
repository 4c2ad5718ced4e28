"""Serving steps: batched prefill and single-token greedy decode.

The paper's §5 names inference KV-cache memory as future work; this module
(with ``core.predictor``'s cache factor) is the program that memory is
predicted for.  It follows the reference's ``repro/serve/serve_step.py``:
the prefill cache is sized to the prompt, :func:`pad_cache` grows it by the
decode budget, and each decode step writes its K/V into the cache in place
(the reference donates the cache to the jitted step so XLA aliases it).

:func:`generate` runs on a CUDA device unless the caller passes
``device="cpu"``; with no card present it raises rather than computing on
the host.  Everything runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.models.param import tensor_from_numpy
from repro_torch.models.registry import Model

# cache leaves with a growable sequence dim (axis 2 of (L, B, S, ...))
_SEQ_KEYS = {"k", "v", "latent", "k_rope"}


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; no CUDA device
    present is an error, never a quiet run on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "generate runs on a CUDA device and none is available; pass "
            "device='cpu' to serve on the host")
    return dev


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch):
        with torch.inference_mode():
            return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    """decode_step(params, token, cache) -> (next_token, logits, cache)."""
    def decode_step(params, token, cache):
        with torch.inference_mode():
            logits, new_cache = model.decode_step(params, token, cache)
            next_token = logits[:, -1].argmax(dim=-1)[:, None] \
                .to(torch.int32)
        return next_token, logits, new_cache
    return decode_step


def pad_cache(cache: dict, extra: int) -> dict:
    """Grow KV-style cache capacity by ``extra`` positions (new tensors;
    the sequence axis is axis 2 of the stacked (L, B, S, ...) leaves)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (F.pad(v, (0, 0) * (v.dim() - 3) + (0, extra))
                        if k in _SEQ_KEYS and isinstance(v, torch.Tensor)
                        and v.dim() >= 3 else walk(v))
                    for k, v in node.items()}
        return node

    with torch.inference_mode():
        return walk(cache)


def _batch_to(batch: dict, device: torch.device) -> dict:
    return {k: v.to(device) if isinstance(v, torch.Tensor)
            else tensor_from_numpy(v, device) for k, v in batch.items()}


def generate(model: Model, params, batch: dict, max_new_tokens: int = 16,
             device=None) -> torch.Tensor:
    """Greedy generation: (B, max_new_tokens) int32 on ``device``.

    ``params`` must already live on ``device``; the batch (tensors or
    numpy arrays) is moved there."""
    dev = resolve_device(device)
    for p in params.parameters():
        if p.device.type != dev.type or (
                dev.index is not None and p.device.index != dev.index):
            raise ValueError(f"generate on {dev}: a parameter lives on "
                             f"{p.device}")
    batch = _batch_to(batch, p.device)
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    logits, cache = prefill(params, batch)
    cache = pad_cache(cache, max_new_tokens)
    with torch.inference_mode():
        tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        tok, _, cache = decode(params, tok, cache)
        out.append(tok)
    return torch.cat(out, dim=1)
