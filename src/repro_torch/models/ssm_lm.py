"""Pure-SSM language model (mamba2-1.3b): embed -> L x [norm + Mamba-2] ->
norm -> tied logits.  Decode is O(1) per token via the recurrent state.

Spec functions, training and the serving path.  ``ssm_loss`` runs
``ssm_backbone`` (each block ``mamba2_forward``, the differentiable
chunked SSD in plain tensor ops, under the reference's remat policy) and
the chunked cross-entropy.  ``ssm_prefill`` runs the chunked SSD (the SSD
kernel) over the prompt and keeps each layer's final recurrent state and
conv tail as the cache; ``ssm_decode_step`` is one recurrent step per
layer.  The cache is stacked as the reference's is — ``{"blocks": {"ssm":
(L, B, H, P, N) fp32, "conv": (L, B, K-1, conv_ch) bf16}, "len": (B,)
int32}`` — and updated per layer in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.spec import ModuleSpec
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.mamba import (mamba2_decode, mamba2_forward,
                                      mamba2_init_state, mamba2_prefill,
                                      mamba2_spec)


def ssm_model_spec(cfg: ArchConfig, name: str = "language_model") -> ModuleSpec:
    children = [
        ModuleSpec(name="embed", modality="text",
                   layers=[L.embedding_spec("tok", cfg.vocab, cfg.d_model,
                                            cfg.dtype, tied=cfg.tie_embeddings)]),
        ModuleSpec(name="blocks", modality="text", repeat=cfg.n_layers,
                   scanned=True,
                   layers=[L.rmsnorm_spec("norm", cfg.d_model, cfg.dtype),
                           mamba2_spec("mixer", cfg.d_model, cfg.ssm,
                                       cfg.dtype)]),
        ModuleSpec(name="head", modality="text",
                   layers=[L.rmsnorm_spec("final_norm", cfg.d_model,
                                          cfg.dtype)]),
    ]
    return ModuleSpec(name=name, modality="text", children=children)


def _meta(cfg: ArchConfig) -> dict:
    return mamba2_spec("mixer", cfg.d_model, cfg.ssm, cfg.dtype).meta


def ssm_backbone(cfg: ArchConfig, p, x: torch.Tensor,
                 remat=None) -> torch.Tensor:
    """x: (B, S, D) embeddings -> final-normed hidden (B, S, D); each block
    (norm + Mamba-2, residual) under the ``remat`` policy (default
    ``cfg.remat``)."""
    meta = _meta(cfg)

    def body(bp, x):
        h = L.rmsnorm(bp.norm, x, cfg.norm_eps)
        return x + mamba2_forward(bp.mixer, h, meta, cfg.norm_eps)

    block = T._remat(body, remat if remat is not None else cfg.remat)
    for bp in p.blocks:
        x = block(bp, x)
    return L.rmsnorm(p.head.final_norm, x, cfg.norm_eps)


def ssm_loss(cfg: ArchConfig, params, batch: dict, remat=None):
    """batch: {'tokens', 'labels': (B, S)} -> (loss, {"xent", "n_tok"})."""
    p = params.language_model
    hidden = ssm_backbone(cfg, p, T.embed_tokens(cfg, p, batch["tokens"]),
                          remat)
    return T.xent_loss(cfg, p, hidden, batch["labels"])


def ssm_init_cache(cfg: ArchConfig, batch: int, max_len: int = 0,
                   device="cuda") -> dict:
    """Zeroed stacked cache (``max_len`` is unused: the state is
    length-free)."""
    one = mamba2_init_state(_meta(cfg), batch, device)
    return {"blocks": {k: torch.zeros((cfg.n_layers,) + tuple(a.shape),
                                      dtype=a.dtype, device=device)
                       for k, a in one.items()},
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def ssm_decode_step(cfg: ArchConfig, params, token: torch.Tensor,
                    cache: dict):
    """token: (B, 1) -> (logits (B, 1, V) fp32, cache).  The cache tensors
    are updated in place; the returned dict carries ``len + 1``."""
    p = params.language_model
    meta = _meta(cfg)
    x = T.embed_tokens(cfg, p, token)
    ssm, conv = cache["blocks"]["ssm"], cache["blocks"]["conv"]
    for i, bp in enumerate(p.blocks):
        h = L.rmsnorm(bp.norm, x, cfg.norm_eps)
        y, ssm[i], conv[i] = mamba2_decode(
            bp.mixer, h, {"ssm": ssm[i], "conv": conv[i]}, meta,
            cfg.norm_eps)
        x = x + y
    x = L.rmsnorm(p.head.final_norm, x, cfg.norm_eps)
    return T.lm_logits(cfg, p, x), {"blocks": {"ssm": ssm, "conv": conv},
                                    "len": cache["len"] + 1}


def ssm_prefill(cfg: ArchConfig, params, batch: dict):
    """Run the chunked SSD over the prompt, keeping each layer's final
    recurrent state and conv tail as the cache -> (last-position logits
    (B, 1, V) fp32, cache)."""
    p = params.language_model
    meta = _meta(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = T.embed_tokens(cfg, p, tokens)
    cache = ssm_init_cache(cfg, B, S, x.device)
    ssm, conv = cache["blocks"]["ssm"], cache["blocks"]["conv"]
    for i, bp in enumerate(p.blocks):
        h = L.rmsnorm(bp.norm, x, cfg.norm_eps)
        y, ssm[i], tail = mamba2_prefill(bp.mixer, h, meta, cfg.norm_eps)
        # a prompt shorter than the window leaves its head at zero, the
        # causal conv's own left padding
        conv[i, :, conv.shape[2] - tail.shape[1]:] = tail
        x = x + y
    cache["len"].fill_(S)
    x = L.rmsnorm(p.head.final_norm, x[:, -1:], cfg.norm_eps)
    return T.lm_logits(cfg, p, x), cache
