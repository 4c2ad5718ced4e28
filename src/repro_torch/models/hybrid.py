"""Hybrid SSM + shared-attention model (zamba2-2.7b).

54 Mamba-2 blocks (stacked per segment) with 2 weight-tied ("shared")
full-attention transformer blocks applied before every ``attn_every``-th
mamba layer, alternating A/B (zamba2's global shared blocks; the
per-invocation LoRA is omitted).  The KV cache exists only for the shared
blocks' invocations, which is why this arch runs long_500k.

Segment ``s`` applies shared block ``s % shared_attn_blocks``, then the
mamba blocks ``[s * every, (s + 1) * every)``.  The shared blocks are the
per-layer :class:`~repro_torch.models.param.StackParams` of a scanned
module, so the same tensors run in several segments and autograd sums
their gradients; the optimizer sees the reference's stacked leaf through
``param.trainable_leaves``.  Only the mamba blocks run under the remat
policy: the shared invocations are unrolled outside it, as the
reference's are and as the byte model counts them (``invocation_repeat``).

Where ``n_layers`` is not a multiple of ``attn_every`` the reference runs
only the first ``(n_layers // attn_every) * attn_every`` mamba blocks
(the spec counts them all, ROADMAP C16); the port runs the same blocks,
and the cache keeps the spec's ``n_layers`` slots, the trailing ones
untouched.

Prefill runs each mamba block through ``mamba2_prefill`` (the SSD kernel)
and keeps its final state and conv tail, as ``ssm_lm.ssm_prefill`` does;
each invocation's K/V comes from ``transformer._prefill_kv`` over its own
``norm1`` (so ``norm1`` runs twice per invocation, as in the reference's
program).  The decode step updates the SSM stacks and each invocation's
K/V (through ``gqa_decode``'s ``index_copy_``) in place.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.spec import ModuleSpec
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.attention import gqa_decode, gqa_forward, gqa_spec
from repro_torch.models.mamba import (mamba2_decode, mamba2_forward,
                                      mamba2_init_state, mamba2_prefill,
                                      mamba2_spec)
from repro_torch.models.ssm_lm import _meta as _ssm_meta


def _n_attn_invocations(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.hybrid.attn_every


def hybrid_model_spec(cfg: ArchConfig, name: str = "language_model") -> ModuleSpec:
    shared = ModuleSpec(
        name="shared_attn", modality="text",
        repeat=cfg.hybrid.shared_attn_blocks, scanned=True,
        layers=[L.rmsnorm_spec("norm1", cfg.d_model, cfg.dtype),
                gqa_spec("attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.resolved_head_dim, dtype=cfg.dtype),
                L.rmsnorm_spec("norm2", cfg.d_model, cfg.dtype),
                L.mlp_spec("ffn", cfg.d_model, cfg.d_ff, cfg.dtype)])
    # Weight tying: 2 distinct blocks, but n_layers/attn_every INVOCATIONS.
    # Params/grads/opt scale with the weight count (repeat=2); activations
    # and KV-cache slots scale with invocations, and the invocations are
    # unrolled (no scan remat).  The predictor reads these markers.
    for lyr in shared.layers:
        lyr.meta["invocation_repeat"] = _n_attn_invocations(cfg)
    shared.layers[1].meta["cache_repeat"] = _n_attn_invocations(cfg)
    children = [
        ModuleSpec(name="embed", modality="text",
                   layers=[L.embedding_spec("tok", cfg.vocab, cfg.d_model,
                                            cfg.dtype, tied=cfg.tie_embeddings)]),
        shared,
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


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _segments(cfg: ArchConfig, p):
    """(segment index, its shared block's params, the indices of its mamba
    blocks) in the order they run."""
    every = cfg.hybrid.attn_every
    nb = cfg.hybrid.shared_attn_blocks
    for s in range(_n_attn_invocations(cfg)):
        yield s, p.shared_attn[s % nb], range(s * every, (s + 1) * every)


def _shared_block(cfg: ArchConfig, sp, x: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(sp.norm1, x, cfg.norm_eps)
    x = x + gqa_forward(sp.attn, h, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads,
                        head_dim=cfg.resolved_head_dim,
                        theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
    h = L.rmsnorm(sp.norm2, x, cfg.norm_eps)
    return x + L.mlp(sp.ffn, h)


def _mamba_body(cfg: ArchConfig, meta: dict, bp,
                x: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(bp.norm, x, cfg.norm_eps)
    return x + mamba2_forward(bp.mixer, h, meta, cfg.norm_eps)


def hybrid_backbone(cfg: ArchConfig, p, x: torch.Tensor,
                    remat=None) -> torch.Tensor:
    """x: (B, S, D) embeddings -> final-normed hidden (B, S, D).  Each
    mamba block (norm + Mamba-2, residual) runs under the ``remat`` policy
    (default ``cfg.remat``); each shared invocation outside it."""
    block = T._remat(functools.partial(_mamba_body, cfg, _ssm_meta(cfg)),
                     remat if remat is not None else cfg.remat)
    for _, sp, layers in _segments(cfg, p):
        x = _shared_block(cfg, sp, x)
        for i in layers:
            x = block(p.blocks[i], x)
    return L.rmsnorm(p.head.final_norm, x, cfg.norm_eps)


def hybrid_loss(cfg: ArchConfig, params, batch: dict, remat=None):
    """batch: {'tokens', 'labels': (B, S)} -> (loss, {"xent", "n_tok"})."""
    p = params.language_model
    hidden = hybrid_backbone(cfg, p, T.embed_tokens(cfg, p, batch["tokens"]),
                             remat)
    return T.xent_loss(cfg, p, hidden, batch["labels"])


def hybrid_init_cache(cfg: ArchConfig, batch: int, max_len: int,
                      device="cuda") -> dict:
    """Zeroed cache: {'blocks': {'ssm': (L, B, H, P, N) fp32, 'conv': (L, B,
    K-1, conv_ch) bf16}, 'attn': {'k', 'v': (n_inv, B, max_len, Hkv, D)
    bf16}, 'len': (B,) int32}."""
    one = mamba2_init_state(_ssm_meta(cfg), batch, device)
    shape = (_n_attn_invocations(cfg), batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"blocks": {k: torch.zeros((cfg.n_layers,) + tuple(a.shape),
                                      dtype=a.dtype, device=device)
                       for k, a in one.items()},
            "attn": {"k": torch.zeros(shape, dtype=torch.bfloat16,
                                      device=device),
                     "v": torch.zeros(shape, dtype=torch.bfloat16,
                                      device=device)},
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def hybrid_decode_step(cfg: ArchConfig, params, token: torch.Tensor,
                       cache: dict):
    """token: (B, 1) -> (logits (B, 1, V) fp32, cache).  The cache tensors
    are updated in place; the returned dict carries ``len + 1``."""
    p = params.language_model
    meta = _ssm_meta(cfg)
    x = T.embed_tokens(cfg, p, token)
    length = cache["len"]
    ssm, conv = cache["blocks"]["ssm"], cache["blocks"]["conv"]
    k, v = cache["attn"]["k"], cache["attn"]["v"]
    for s, sp, layers in _segments(cfg, p):
        h = L.rmsnorm(sp.norm1, x, cfg.norm_eps)
        a, _ = gqa_decode(sp.attn, h, {"k": k[s], "v": v[s], "len": length},
                          n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.resolved_head_dim,
                          theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
        x = x + a
        h = L.rmsnorm(sp.norm2, x, cfg.norm_eps)
        x = x + L.mlp(sp.ffn, h)
        for i in layers:
            bp = p.blocks[i]
            h = L.rmsnorm(bp.norm, x, cfg.norm_eps)
            y, ssm[i], conv[i] = mamba2_decode(
                bp.mixer, h, {"ssm": ssm[i], "conv": conv[i]}, meta,
                cfg.norm_eps)
            x = x + y
    x = L.rmsnorm(p.head.final_norm, x, cfg.norm_eps)
    return T.lm_logits(cfg, p, x), {"blocks": {"ssm": ssm, "conv": conv},
                                    "attn": {"k": k, "v": v},
                                    "len": length + 1}


def hybrid_prefill(cfg: ArchConfig, params, batch: dict):
    """The chunked SSD over the prompt (the SSD kernel) keeping each mamba
    block's final state and conv tail, and each shared invocation's K/V
    written into the stacked cache -> (last-position logits (B, 1, V)
    fp32, cache sized to S)."""
    p = params.language_model
    meta = _ssm_meta(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = T.embed_tokens(cfg, p, tokens)
    cache = hybrid_init_cache(cfg, B, S, x.device)
    ssm, conv = cache["blocks"]["ssm"], cache["blocks"]["conv"]
    for s, sp, layers in _segments(cfg, p):
        h = L.rmsnorm(sp.norm1, x, cfg.norm_eps)
        for name, t in T._prefill_kv(cfg, sp.attn, h).items():
            cache["attn"][name][s] = t
        del h
        x = _shared_block(cfg, sp, x)
        for i in layers:
            bp = p.blocks[i]
            h = L.rmsnorm(bp.norm, x, cfg.norm_eps)
            y, ssm[i], tail = mamba2_prefill(bp.mixer, h, meta, cfg.norm_eps)
            # a prompt shorter than the window leaves its head at zero, the
            # causal conv's own left padding (C10)
            conv[i, :, conv.shape[2] - tail.shape[1]:] = tail
            x = x + y
    cache["len"].fill_(S)
    x = L.rmsnorm(p.head.final_norm, x[:, -1:], cfg.norm_eps)
    return T.lm_logits(cfg, p, x), cache
